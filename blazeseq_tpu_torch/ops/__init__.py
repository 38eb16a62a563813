"""Device ops of the PyTorch port, each with a plain torch version beside its
CUDA kernel where the reference had a Pallas kernel.

The names are the reference's (blazeseq_tpu/ops/__init__.py) for every
ported module. The reference's `*_pallas` / `*_xla` pairs become one
dispatching op and its plain torch version: `validate_decode` /
`validate_decode_torch`, `nw_scores` / `nw_scores_torch`, and the XLA-only
alignment variants drop the suffix (`sw_scores`, `nw_affine_scores`, ...).
Not ported yet: `ragged_qc` (ROADMAP Queue 1 item 8); `use_interpret` is a
TPU-only knob.
"""

from .adapter import AdapterStats, adapter_content, adapter_content_cpu
from .common import length_mask, round_up
from .dedup import (duplication_levels, overrepresented_sequences,
                    read_hashes, read_hashes_cpu)
from .demux import (demultiplex_counts, demultiplex_to_writers, demux_assign,
                    demux_assign_host)
from .kmer import kmer_counts, kmer_counts_cpu
from .merge import MergeResult, merge_pairs, merge_pairs_host
from .nw import (needleman_wunsch_affine_cpu, needleman_wunsch_cpu,
                 nw_affine_scores, nw_scores, nw_scores_torch,
                 nw_semiglobal_affine_scores, nw_semiglobal_scores,
                 semiglobal_affine_cpu, semiglobal_cpu,
                 smith_waterman_affine_cpu, smith_waterman_cpu,
                 sw_affine_scores, sw_scores)
from .raw_stats import RawStreamQC, raw_stream_qc
from .scan import (count_records_device, gather_padded_device,
                   newline_positions_device, parse_fastq_device,
                   record_offsets_device, structural_bitmaps,
                   structural_bitmaps_torch)
from .stats import (GC_BINS, LEN_BINS, MAX_PHRED, QCAccumulator, QCStats,
                    qc_stats, row_histograms, row_partials, zero_stats)
from .tiles import (PerTileAccumulator, parse_illumina_tiles,
                    per_tile_qual_sums)
from .trim import (bwa_trim, bwa_trim_cpu, clip_ends, clip_ends_cpu,
                   sliding_window_trim, sliding_window_trim_cpu)
from .uniform_parse import (UniformLayout, UniformParseResult,
                            detect_uniform_layout, uniform_parse)
from .validate import validate_decode, validate_decode_torch
