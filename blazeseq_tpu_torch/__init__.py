"""blazeseq_tpu_torch: the PyTorch + CUDA port of blazeseq_tpu.

The device layer runs on torch tensors, with hand-written Hopper kernels
(``csrc/``) where the reference had Pallas kernels. The host layer (readers,
parser, quality schemas, the native C/C++ scanner under ``native/``, FASTA
and FAI, the HTML report) is the package's own copy of the reference's and
loads no JAX; nothing here imports ``blazeseq_tpu``. Entry points::

    from blazeseq_tpu_torch import NWAligner, QCModel
    report = QCModel(quality_schema="sanger").run_file_device("reads.fastq")
    report = QCModel(quality_schema="sanger", align_to=ref).run_file(path)
    scores = NWAligner(ref).score_padded(padded_batch)

The device ops (the device-parse API, trimming, k-mers, tiles, demux,
merge) are in ``blazeseq_tpu_torch.ops`` under the reference's names, and
``python -m blazeseq_tpu_torch`` is the command line.
"""

from .constants import DEFAULT_BATCH_SIZE
from .fastq.parser import FastqParser, ParserConfig
from .fastq.quality import parse_schema
from .io.readers import MemoryReader, MmapReader, open_reader
from .models.aligner import NWAligner
from .models.qc import QCModel, QCReport
from .utils import generate_synthetic_fastq_buffer

__all__ = ["FastqParser", "MemoryReader", "MmapReader", "NWAligner",
           "ParserConfig", "QCModel", "QCReport",
           "generate_synthetic_fastq_buffer", "open_reader", "parse_schema",
           "parser"]


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
