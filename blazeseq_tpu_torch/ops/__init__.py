"""Device ops of the PyTorch port, each with a plain torch version beside its
CUDA kernel where the reference had a Pallas kernel.

The names are the reference's (blazeseq_tpu/ops/__init__.py) for every
ported module. The reference's `*_pallas` / `*_xla` pairs become one
dispatching op and its plain torch version: `validate_decode` /
`validate_decode_torch`, `nw_scores` / `nw_scores_torch`, and the XLA-only
alignment variants drop the suffix (`sw_scores`, `nw_affine_scores`, ...)
and dispatch to csrc/nw.cu's variant kernel beside their plain versions
(`sw_scores_torch`, ...; `nw_variant_scores` counts their launches).
`ragged_qc` (XLA code in the reference) gets a hand-written kernel too, and
`ragged_qc_torch` beside it; so do the padded-batch panels `qc_stats`,
`adapter_content` and `read_hashes` (`qc_stats_torch`,
`adapter_content_torch`, `read_hashes_torch`), and the device-parse API
(csrc/parse.cu: `raw_stream_qc_torch`, `newline_positions_torch`,
`record_offsets_torch`, `gather_padded_torch`, `count_records_torch`),
`merge_pairs` (csrc/merge.cu; `merge_pairs_torch`) and the CLI's device
ops: `clip_ends`, `sliding_window_trim` and `bwa_trim` (csrc/trim.cu;
`*_torch`), `demux_assign` (csrc/demux.cu; `demux_assign_torch`),
`per_tile_qual_sums` (csrc/tiles.cu; `per_tile_qual_sums_torch`) and
`kmer_counts` (csrc/kmer.cu; `kmer_counts_torch`).
`use_interpret` is a TPU-only knob and is not ported.
"""

from .adapter import (AdapterStats, adapter_content, adapter_content_cpu,
                      adapter_content_torch)
from .common import length_mask, round_up
from .dedup import (duplication_levels, overrepresented_sequences,
                    read_hashes, read_hashes_cpu, read_hashes_torch)
from .demux import (demultiplex_counts, demultiplex_to_writers, demux_assign,
                    demux_assign_host, demux_assign_torch)
from .kmer import kmer_counts, kmer_counts_cpu, kmer_counts_torch
from .merge import (MergeResult, merge_pairs, merge_pairs_host,
                    merge_pairs_torch)
from .nw import (needleman_wunsch_affine_cpu, needleman_wunsch_cpu,
                 nw_affine_scores, nw_affine_scores_torch, nw_scores,
                 nw_scores_torch, nw_semiglobal_affine_scores,
                 nw_semiglobal_affine_scores_torch, nw_semiglobal_scores,
                 nw_semiglobal_scores_torch, nw_variant_scores,
                 semiglobal_affine_cpu, semiglobal_cpu,
                 smith_waterman_affine_cpu, smith_waterman_cpu,
                 sw_affine_scores, sw_affine_scores_torch, sw_scores,
                 sw_scores_torch)
from .ragged_qc import RaggedQC, ragged_qc, ragged_qc_torch
from .raw_stats import RawStreamQC, raw_stream_qc, raw_stream_qc_torch
from .scan import (count_records_device, count_records_torch,
                   gather_padded_device, gather_padded_torch,
                   newline_positions_device, newline_positions_torch,
                   parse_fastq_device, record_offsets_device,
                   record_offsets_torch, structural_bitmaps,
                   structural_bitmaps_torch)
from .stats import (GC_BINS, LEN_BINS, MAX_PHRED, QCAccumulator, QCStats,
                    qc_stats, qc_stats_torch, row_histograms, row_partials,
                    zero_stats)
from .tiles import (PerTileAccumulator, parse_illumina_tiles,
                    per_tile_qual_sums, per_tile_qual_sums_torch)
from .trim import (bwa_trim, bwa_trim_cpu, bwa_trim_torch, clip_ends,
                   clip_ends_cpu, clip_ends_torch, sliding_window_trim,
                   sliding_window_trim_cpu, sliding_window_trim_torch)
from .uniform_parse import (UniformLayout, UniformParseResult,
                            detect_uniform_layout, uniform_parse)
from .validate import validate_decode, validate_decode_torch
