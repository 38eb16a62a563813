"""Central constants (reference: blazeseq/CONSTS.mojo:6-31)."""

KB = 1024
MB = 1024 * KB
GB = 1024 * MB

# FASTQ/FASTA line markers (ASCII codes)
READ_HEADER = 64  # ord("@")
QUALITY_HEADER = 43  # ord("+")
NEW_LINE = 10  # ord("\n")
CARRIAGE_RETURN = 13  # ord("\r")
FASTA_HEADER = 62  # ord(">")

# Sentinel error message for end-of-stream.
EOF = "EOF"

# Buffer and capacity
DEFAULT_CAPACITY = 256 * KB
MAX_SHIFT = 30
MAX_CAPACITY = 2**MAX_SHIFT

# Default max records per batch for parser.batches() / next_batch().
DEFAULT_BATCH_SIZE = 4096

# Host streaming chunk size for the vectorized scan path. Sized so a chunk of
# raw bytes plus its offset table stays comfortably in L2/L3 while amortizing
# per-chunk Python overhead.
DEFAULT_CHUNK_SIZE = 1 * MB

# Device-side padding unit: TPU lane width. All padded batch dims are rounded
# up to a multiple of this.
TPU_LANE = 128
