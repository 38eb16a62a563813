"""The padded-batch step, the overlapped host-to-device chunk feed, the
multi-core host feed and record-boundary sharding. The mesh names of the
reference's package (multi-GPU) are not ported yet."""

from .feed import parallel_count, parallel_padded_batches
from .pipeline import QCAlignResult, build_qc_align_step, run_qc_align
from .sharding import RangeReader, find_record_boundary, open_shard, shard_file
