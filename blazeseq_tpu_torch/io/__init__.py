"""Byte sources/sinks, buffered windows, line iteration, delimited engine."""

from .buffered import ByteStream, LineIterator, LineIteratorError
from .delimited import (
    DefaultLinePolicy,
    DelimitedReader,
    DelimitedRecord,
    DelimitedView,
    LineAction,
)
from .readers import (
    FileReader,
    GZFile,
    MemoryReader,
    ParallelGzipReader,
    RapidgzipReader,
    Reader,
    open_reader,
)
from .writers import (
    BGZFWriter,
    BufferedWriter,
    FileWriter,
    GZWriter,
    MemoryWriter,
    buffered_writer_for_file,
    buffered_writer_for_gzip,
    buffered_writer_for_memory,
)
