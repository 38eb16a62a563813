"""Phred quality schemas (reference: blazeseq/fastq/quality_schema.mojo:26-31).

Values derive from BioJulia FASTX.jl quality tables. Each schema carries the
inclusive ASCII byte range [LOWER, UPPER] considered valid and the OFFSET used
to decode Phred scores.

Note: the reference's SIMD validation path treats UPPER as exclusive while its
scalar tail treats it as inclusive (blazeseq/fastq/record.mojo:119-148). We use
the inclusive (scalar) semantics everywhere, matching the documented schema.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QualitySchema:
    SCHEMA: str
    LOWER: int
    UPPER: int
    OFFSET: int

    def __str__(self) -> str:
        return (
            "Quality schema: %s\nLower: %d\nUpper: %d\nOffset: %d"
            % (self.SCHEMA, self.LOWER, self.UPPER, self.OFFSET)
        )


GENERIC_SCHEMA = QualitySchema("Generic", 33, 126, 33)
SANGER_SCHEMA = QualitySchema("Sanger", 33, 126, 33)
SOLEXA_SCHEMA = QualitySchema("Solexa", 59, 126, 64)
ILLUMINA_1_3_SCHEMA = QualitySchema("Illumina v1.3", 64, 126, 64)
ILLUMINA_1_5_SCHEMA = QualitySchema("Illumina v1.5", 66, 126, 64)
ILLUMINA_1_8_SCHEMA = QualitySchema("Illumina v1.8", 33, 126, 33)

_SCHEMAS = {
    "generic": GENERIC_SCHEMA,
    "sanger": SANGER_SCHEMA,
    "solexa": SOLEXA_SCHEMA,
    "illumina_1.3": ILLUMINA_1_3_SCHEMA,
    "illumina_1.5": ILLUMINA_1_5_SCHEMA,
    "illumina_1.8": ILLUMINA_1_8_SCHEMA,
}


def parse_schema(quality_format: str) -> QualitySchema:
    """Resolve a schema name; unknown names warn and fall back to generic
    (reference: blazeseq/utils.mojo:614-637)."""
    schema = _SCHEMAS.get(quality_format)
    if schema is None:
        print(
            "Unknown quality schema please choose one of 'sanger', 'solexa',"
            " 'illumina_1.3', 'illumina_1.5' 'illumina_1.8', or 'generic'."
            " Parsing with generic schema."
        )
        return GENERIC_SCHEMA
    return schema


# schema-key reverse map (kept NEXT to _SCHEMAS so a renamed/added schema
# cannot silently drift from callers that need the string key back)
_SCHEMA_KEYS = {v.SCHEMA: k for k, v in _SCHEMAS.items() if k != "generic"}


def schema_key(schema: QualitySchema) -> str:
    """The _SCHEMAS name for a schema instance ("sanger", ...)."""
    return _SCHEMA_KEYS.get(schema.SCHEMA, "generic")


def detect_quality_schema(data: bytes, max_records: int = 10_000,
                          default: "QualitySchema | None" = GENERIC_SCHEMA
                          ) -> QualitySchema:
    """Infer the Phred encoding from quality bytes (the FastQC heuristic;
    beyond the reference, which requires an explicit schema).

    Scans up to `max_records` records and classifies by the minimum
    quality byte observed:

      min < 59   -> sanger       (Phred+33; includes Illumina 1.8+)
      59..63     -> solexa       (Solexa+64)
      64..65     -> illumina_1.3 (Phred+64)
      min >= 66  -> illumina_1.5 (Phred+64, no bytes below 'B')

    Uniformly high-quality data is inherently ambiguous (all encodings
    overlap at the top of the range); like FastQC, the narrowest schema
    consistent with the evidence is returned. An empty or record-less
    head returns `default` (generic — every explicit-schema entry point
    handles empty input gracefully, so "auto" must too); pass
    default=None to raise ValueError instead. Structurally invalid bytes
    still raise ParseError."""
    from ..io.readers import MemoryReader
    from .parser import FastqParser, ParserConfig

    cfg = ParserConfig(check_ascii=False, check_quality=False)
    parser = FastqParser(MemoryReader(bytes(data)), config=cfg)
    lo = 256
    n = 0
    try:
        for v in parser.views():
            q = v.quality_bytes()
            if q:
                m = min(q)
                if m < lo:
                    lo = m
            n += 1
            if n >= max_records or lo < 59:
                break
    except Exception:
        if n == 0:
            raise
    if n == 0:
        if default is not None:
            return default
        raise ValueError("detect_quality_schema: no complete FASTQ record")
    if lo < 59:
        return SANGER_SCHEMA
    if lo < 64:
        return SOLEXA_SCHEMA
    if lo < 66:
        return ILLUMINA_1_3_SCHEMA
    return ILLUMINA_1_5_SCHEMA


def detect_quality_schema_file(path: str, head_bytes: int = 1 << 20,
                               max_records: int = 10_000) -> QualitySchema:
    """detect_quality_schema over a file head (plain or gzip: any
    open_reader-supported source; bytes are read DECOMPRESSED)."""
    from ..io.readers import open_reader

    reader = open_reader(path)
    try:
        buf = bytearray()
        scratch = bytearray(1 << 16)
        while len(buf) < head_bytes:
            n = reader.readinto(memoryview(scratch))
            if n == 0:
                break
            buf += scratch[:n]
    finally:
        close = getattr(reader, "close", None)
        if close is not None:
            close()
    # drop a trailing partial record (harmless for detection)
    return detect_quality_schema(bytes(buf), max_records=max_records)
