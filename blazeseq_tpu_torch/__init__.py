"""blazeseq_tpu_torch: the PyTorch + CUDA port of blazeseq_tpu.

The device layer runs on torch tensors, with hand-written Hopper kernels
(``csrc/``) where the reference had Pallas kernels. The host layer (readers
and writers, parser, quality schemas, the native C/C++ scanner under
``native/``, FASTA and FAI, BED, GFF3 and GTF, the multi-core host feed, the
HTML report) is the package's own copy of the reference's and loads no JAX;
nothing here imports ``blazeseq_tpu``. The package exports every top-level
name of the reference. Entry points::

    from blazeseq_tpu_torch import NWAligner, QCModel
    report = QCModel(quality_schema="sanger").run_file_device("reads.fastq")
    report = QCModel(quality_schema="sanger", align_to=ref).run_file(path)
    scores = NWAligner(ref).score_padded(padded_batch)

The device ops (the device-parse API, trimming, k-mers, tiles, demux,
merge) are in ``blazeseq_tpu_torch.ops`` under the reference's names, and
``python -m blazeseq_tpu_torch`` is the command line.
"""

from .constants import DEFAULT_BATCH_SIZE, DEFAULT_CAPACITY, EOF
from .errors import (
    FastxEOFError,
    FastxError,
    FastxErrorCode,
    ParseContext,
    ParseError,
    ValidationError,
)
from .bed.parser import BedParser, BedWriter
from .bed.record import BedRecord, BedView, ItemRgb, Strand
from .fai.parser import FaiParser, IndexedFasta, build_fai, write_fai
from .fai.record import FaiRecord, FaiView
from .fasta.parser import FastaBatch, FastaParser, FastaParserConfig
from .fasta.record import FastaRecord
from .fastq.batch import (DeviceFastqBatch, FastqBatch, PaddedFastqBatch,
                          upload_batch_to_device)
from .fastq.index import (FastqIndex, IndexedFastq,
                          build_fqi, read_fqi, write_fqi)
from .fastq.paired import (InterleavedFastqParser,
                           PairedFastqParser, PairSyncError)
from .fastq.parser import FastqParser, ParserConfig
from .fastq.quality import (QualitySchema,
                            detect_quality_schema,
                            detect_quality_schema_file,
                            parse_schema)
from .fastq.record import Definition, FastqRecord, FastqView, Validator
from .features.ranges import Interval, Position
from .gff.attributes import Gff3Attributes, parse_gff3_attributes
from .gff.parser import Gff3Parser
from .gff.record import Gff3Record, Gff3Strand, SequenceRegion
from .gtf.attributes import GtfAttributes, parse_gtf_attributes
from .gtf.parser import GtfParser, GtfRecord
from .io.buffered import ByteStream, LineIterator, LineIteratorError
from .io.delimited import (
    DefaultLinePolicy,
    DelimitedReader,
    DelimitedRecord,
    DelimitedView,
    LineAction,
)
from .io.readers import (
    BgzfReader,
    FileReader,
    MmapReader,
    GZFile,
    MemoryReader,
    ParallelGzipReader,
    RapidgzipReader,
    open_reader,
    scan_bgzf_blocks,
)
from .io.writers import (
    BGZFWriter,
    BufferedWriter,
    FileWriter,
    GZWriter,
    MemoryWriter,
    buffered_writer_for_file,
    buffered_writer_for_gzip,
    buffered_writer_for_memory,
)
from .models.aligner import NWAligner
from .models.qc import QCModel, QCReport
from .utils import (
    compute_num_fasta_reads_for_size,
    compute_num_reads_for_size,
    generate_synthetic_fasta_buffer,
    generate_synthetic_fastq_buffer,
    generate_synthetic_fastq_to_writer,
    generate_variable_id_fastq_buffer,
)

__version__ = "0.7.0"


def parser(path, quality_schema: str = "generic", parallelism: int = 4,
           validate: bool = False, batch_size: int = DEFAULT_BATCH_SIZE):
    """A FastqParser over `path`, plain or gzip by its suffix (the
    reference's `blazeseq_tpu.parser`). quality_schema="auto" infers the
    Phred encoding from the file head."""
    if quality_schema == "auto":
        from .fastq.quality import detect_quality_schema_file, schema_key

        quality_schema = schema_key(detect_quality_schema_file(path))
    cfg = ParserConfig(check_ascii=validate, check_quality=validate,
                       quality_schema=quality_schema)
    return FastqParser(open_reader(path, parallelism=parallelism),
                       batch_size=batch_size, config=cfg)
