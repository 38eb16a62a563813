"""The analysis steps, on one device or over a mesh (counterpart of
blazeseq_tpu/parallel/pipeline.py).

`build_qc_align_step` validates and decodes a padded batch (ops/validate.py),
runs `qc_stats` with the error codes and, with alignment, scores every row
against the reference (ops/nw.py). `build_uniform_qc_step` and
`build_ragged_qc_step` parse raw FASTQ bytes on the device with the one-pass
kernels (ops/uniform_qc.py, ops/ragged_qc.py).

With a mesh (parallel/mesh.py) every rank runs the step on its own block, as
`shard_batch` gives it, and the statistics merge with collectives: the
reference's `psum` is a sum over the mesh axis (one flat collective for
every leaf), `pmin` / `pmax` are MIN / MAX all-reduces, and outputs the
reference returns sharded per device (`per_shard`, the ragged verdicts) are
all-gathered, so every rank holds the whole [D] vector. Every rank's
statistics equal the single-device step's on the whole batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import nw as nw_ops
from ..ops import stats as stats_ops
from ..ops import validate as validate_ops
from ..ops.common import resolve_device
from .mesh import (DP_AXIS, SP_AXIS, all_gather, all_reduce, all_to_all,
                   axis_index, axis_size, check_mesh, mesh_device,
                   psum_tuple, replicated, shard_batch)


class QCAlignResult(NamedTuple):
    stats: stats_ops.QCStats
    error_codes: torch.Tensor  # int32[n] per-record validation codes
    phred: torch.Tensor  # u8[n, L] decoded scores
    nw_scores: torch.Tensor  # int32[n] scores against the reference


def _scores(seq, lengths, ref, with_alignment):
    if not with_alignment:
        return torch.zeros(seq.shape[0], dtype=torch.int32,
                           device=seq.device)
    if ref is None:
        raise ValueError("the alignment step needs a reference")
    # lengths may exceed the padded width for clamped long reads
    return nw_ops.nw_scores(seq, torch.clamp(lengths, max=seq.shape[1]), ref)


def _local_step(seq, qual, lengths, n_records, schema, ref=None, *,
                check_ascii: bool, check_quality: bool, with_alignment: bool,
                qual_hist_2d: bool, out=None):
    codes, phred = validate_ops.validate_decode(
        seq, qual, lengths, schema, check_ascii=check_ascii,
        check_quality=check_quality)
    st = stats_ops.qc_stats(seq, qual, lengths, int(schema.OFFSET),
                            n_records=n_records, error_codes=codes,
                            qual_hist_2d=qual_hist_2d, out=out)
    return QCAlignResult(st, codes, phred,
                         _scores(seq, lengths, ref, with_alignment))


def _local_record_count(block: int, n_records: int, idx: int) -> int:
    """Records owned by shard `idx` when the leading dim is block-sharded:
    rows [idx*block, (idx+1)*block) intersected with [0, n_records)."""
    return max(0, min(int(n_records) - idx * block, block))


def _widen_columns(st, col0: int, width: int):
    """The per-position leaves of a column slice placed at [col0, col0 + w)
    of `width` columns, zeros elsewhere: summed over 'sp' they give the
    whole-row leaves."""
    def pad(a):
        return torch.nn.functional.pad(a, (col0, width - col0 - a.shape[-1]))

    return st._replace(
        per_pos_base_counts=pad(st.per_pos_base_counts),
        per_pos_qual_sum=pad(st.per_pos_qual_sum),
        per_pos_count=pad(st.per_pos_count),
        per_pos_qual_hist=(None if st.per_pos_qual_hist is None
                           else pad(st.per_pos_qual_hist)))


def _aligned_at_full_width(mesh, seq, lengths, ref, sp_axis):
    """NW needs whole rows, which no rank of an 'sp' mesh holds. Rank i of
    the 'sp' group takes row block i of its dp block at full width (an
    all-to-all of the column slabs), scores it, and the blocks are gathered
    back, so every 'sp' rank returns its dp block's scores."""
    k = axis_size(mesh, sp_axis)
    i = axis_index(mesh, sp_axis)
    n, w = seq.shape
    if n % k:
        raise ValueError("the alignment sub-step needs a row block (%d) "
                         "divisible by the %d 'sp' ranks" % (n, k))
    m = n // k
    group = mesh.get_group(sp_axis)
    slabs = all_to_all(seq, group).view(k, m, w)
    rows = slabs.permute(1, 0, 2).reshape(m, k * w)
    lens = torch.clamp(lengths[i * m:(i + 1) * m], max=k * w)
    return all_gather(nw_ops.nw_scores(rows, lens, ref), group)


def _mesh_step(seq, qual, lengths, n_records, schema, ref=None, *, mesh,
               axis_name: str, sp_axis, check_ascii: bool,
               check_quality: bool, with_alignment: bool,
               qual_hist_2d: bool):
    n, w = seq.shape
    n_local = _local_record_count(n, n_records, axis_index(mesh, axis_name))
    offset = int(schema.OFFSET)
    if sp_axis is None:
        res = _local_step(seq, qual, lengths, n_local, schema, ref,
                          check_ascii=check_ascii,
                          check_quality=check_quality,
                          with_alignment=with_alignment,
                          qual_hist_2d=qual_hist_2d)
        return res._replace(stats=psum_tuple(mesh, res.stats, (axis_name,)))
    # this rank holds columns [col0, col0 + w) of every record of its dp
    # block
    sp_idx = axis_index(mesh, sp_axis)
    col0 = sp_idx * w
    codes, phred = validate_ops.validate_decode(
        seq, qual, lengths, schema, check_ascii=check_ascii,
        check_quality=check_quality, col_offset=col0)
    # a record's error can live in any position slice: every sp rank takes
    # the record's whole-row code, where a high bit (4) wins over a quality
    # out of range (5) as on one device, so 4 ranks above 5 for the MAX
    # (the reference's plain pmax returns 5 for a row with both)
    top = validate_ops.QUALITY_OUT_OF_RANGE + 1
    codes = torch.where(codes == validate_ops.ASCII_INVALID, top, codes)
    codes = all_reduce(codes, mesh.get_group(sp_axis), dist.ReduceOp.MAX)
    codes = torch.where(codes == top, validate_ops.ASCII_INVALID, codes)
    # per-record scalars and the per-read panels are kept on sp rank 0
    # only; the position-partitioned leaves are each rank's own
    first = sp_idx == 0
    st = stats_ops.qc_stats(seq, qual, lengths, offset, n_records=n_local,
                            error_codes=codes, col_offset=col0,
                            count_scalars=first, row_stats=False,
                            qual_hist_2d=qual_hist_2d)
    # the per-read panels need whole rows: sum the per-read partials over
    # the position slices, then bin
    parts = torch.stack(stats_ops.row_partials(
        seq, qual, lengths, offset, n_records=n_local, col_offset=col0))
    gcr, qsr, cntr = all_reduce(parts, mesh.get_group(sp_axis)).unbind(0)
    if first:
        len_h, gc_h, mq_h = stats_ops.row_histograms(gcr, qsr, cntr, lengths,
                                                     n_local)
        st = st._replace(length_hist=len_h, gc_hist=gc_h,
                         mean_qual_hist=mq_h)
    st = _widen_columns(st, col0, w * axis_size(mesh, sp_axis))
    st = psum_tuple(mesh, st, (axis_name, sp_axis))
    if with_alignment:
        if ref is None:
            raise ValueError("the alignment step needs a reference")
        scores = _aligned_at_full_width(mesh, seq, lengths, ref, sp_axis)
    else:
        scores = _scores(seq, lengths, ref, False)
    return QCAlignResult(st, codes, phred, scores)


def build_qc_align_step(mesh=None, *, check_ascii: bool = True,
                        check_quality: bool = True,
                        with_alignment: bool = False,
                        qual_hist_2d: bool = False,
                        axis_name: str = DP_AXIS):
    """Build the analysis step.

    Returns fn(seq u8[n, L], qual u8[n, L], lengths int32[n], n_records,
    schema, ref=None) -> QCAlignResult, where `schema` is the QualitySchema
    whose LOWER / UPPER / OFFSET bound and decode the quality bytes, and
    `ref` (u8[Lr] on the batch's device) is the reference the rows are
    aligned to when `with_alignment`; without it the scores are zeros.
    Without a mesh fn also takes `out=`, a running total of earlier
    batches' stats (see ops/stats.qc_stats): the batch's stats are added
    into it and `stats` is `out`.

    With a mesh every rank calls fn on its block (`shard_batch`: rows over
    `axis_name`, and on a mesh with an 'sp' axis of more than one rank the
    columns over 'sp'), with the GLOBAL n_records; the global row count
    must divide by the mesh's size. Then:
      * `stats` is whole and the same on every rank: each leaf equals the
        single-device step's on the whole batch (the per-position leaves
        span every column under 'sp');
      * `error_codes` and `nw_scores` are this rank's dp row block (the
        same on every 'sp' rank of it), `phred` its [rows, columns] block;
        `gather_rows(mesh, t)` gives the global tensor.
    Under 'sp' the alignment runs at full width: each rank of a dp block's
    'sp' group scores a disjoint row range, as in the reference."""
    kw = dict(check_ascii=check_ascii, check_quality=check_quality,
              with_alignment=with_alignment, qual_hist_2d=qual_hist_2d)
    if mesh is None:
        return functools.partial(_local_step, **kw)
    check_mesh(mesh, "build_qc_align_step")
    sp = SP_AXIS if axis_size(mesh, SP_AXIS) > 1 else None
    return functools.partial(_mesh_step, mesh=mesh, axis_name=axis_name,
                             sp_axis=sp, **kw)


def run_qc_align(padded_batch, ref, schema, mesh=None, *, device="cuda",
                 with_alignment: bool = True, **kw) -> QCAlignResult:
    """Run the analysis step on one PaddedFastqBatch against the reference
    read `ref` (bytes or a u8 array), with alignment unless asked not to,
    as the reference's wrapper does. The batch and `ref` go to `device`:
    "cuda" (the default) needs a card and raises without one; "cpu" runs
    the plain versions of the kernels. With a mesh, the mesh must be on
    `device`'s type and this rank's block goes to its device (see
    build_qc_align_step for what the result holds). `kw` goes to
    build_qc_align_step."""
    step = build_qc_align_step(mesh, with_alignment=with_alignment, **kw)
    arrays = (padded_batch.seq, padded_batch.qual,
              np.asarray(padded_batch.lengths, np.int32))
    refv = (np.frombuffer(bytes(ref), np.uint8).copy()
            if isinstance(ref, (bytes, bytearray))
            else np.asarray(ref, np.uint8))
    if mesh is None:
        dev = resolve_device(device, "run_qc_align")
        seq, qual, lengths = (torch.from_numpy(np.ascontiguousarray(a))
                              .to(dev) for a in arrays)
        refv = torch.from_numpy(refv).to(dev)
    else:
        mesh_device(mesh, device, "run_qc_align")
        seq, qual, lengths = shard_batch(mesh, *arrays)
        refv = replicated(mesh).local(refv)
    return step(seq, qual, lengths, int(padded_batch.n_records), schema, refv)


def _masked(st, keep: torch.Tensor):
    """The stats times a bool[] verdict: a failed shard adds nothing."""
    return type(st)(*(None if a is None else a * keep.to(a.dtype)
                      for a in st))


def build_uniform_qc_step(mesh, layout, schema, *, width: int = 128,
                          check_ascii: bool = True,
                          check_quality: bool = True,
                          axis_name: str = DP_AXIS,
                          per_shard: bool = False):
    """The uniform-template parse + QC step on kernel B
    (ops/uniform_qc.uniform_qc), on one device or over a mesh.

    `layout` is the file's UniformLayout and `schema` its QualitySchema.
    Returns fn(chunk u8[nrec, rs], n_valid) -> (n_records int32[], bases
    int32[], ok bool[], QCStats). Rows at or past n_valid // rs are
    padding. The reference's 1-D chunk form (a TPU layout knob) is
    refused. Every violation rejects (ok=False) exactly like the
    single-device path, so the host fallback contract carries over.

    With a mesh each rank passes its row block (`shard_batch`) and the
    global `n_valid`; it proves the template and computes the stats of its
    rows, and the stats, counts and bases sum over the mesh while `ok` is
    their MIN. With per_shard=True fn returns (n_records int32[D],
    bases int32[D], ok bool[D], QCStats): index d is shard d's verdict and
    counts, and the summed stats include only passing shards (a failed
    shard's are zeroed before the collective), so the host re-parses just
    the failing shards' byte ranges."""
    from ..ops.uniform_qc import uniform_qc

    if mesh is not None:
        check_mesh(mesh, "build_uniform_qc_step")
    rs = layout.rs
    kw = dict(rs=rs, o1=layout.o1, o2=layout.o2, o3=layout.o3, width=width,
              q_lo=int(schema.LOWER), q_hi=int(schema.UPPER),
              offset=int(schema.OFFSET), check_ascii=check_ascii,
              check_quality=check_quality)

    def step(chunk, n_valid):
        if chunk.dim() != 2 or chunk.shape[1] != rs:
            raise ValueError(
                "build_uniform_qc_step: chunk must be u8[nrec, %d] (the "
                "1-D chunk form is a TPU layout the port does not take), "
                "got %s" % (rs, tuple(chunk.shape)))
        if mesh is None:
            ok, st = uniform_qc(chunk, n_valid, **kw)
            return st.reads, st.bases, ok, st
        rows = chunk.shape[0]
        start = axis_index(mesh, axis_name) * rows
        local = min(max(int(n_valid) // rs - start, 0), rows) * rs
        ok, st = uniform_qc(chunk, local, **kw)
        group = mesh.get_group(axis_name)
        if per_shard:
            mine = torch.stack([st.reads, st.bases, ok.to(torch.int32)])
            n_rec, bases, oks = all_gather(mine[None], group).unbind(1)
            st = psum_tuple(mesh, _masked(st, ok), (axis_name,))
            return n_rec, bases, oks > 0, st
        st = psum_tuple(mesh, st, (axis_name,))
        ok = all_reduce(ok.to(torch.int32), group, dist.ReduceOp.MIN) > 0
        return st.reads, st.bases, ok, st

    return step


def build_ragged_qc_step(mesh, schema, *, width: int = 128,
                         slot_cap: int = 12, check_ascii: bool = True,
                         check_quality: bool = True,
                         axis_name: str = DP_AXIS):
    """The general (ragged-layout) parse + QC step on the ragged kernel
    (ops/ragged_qc.ragged_qc), over D record-boundary shards of a file.

    The caller cuts the file at record boundaries on the host
    (parallel/sharding.find_record_boundary) and zero-pads every shard to
    a common S bytes: a flat u8[D*S] array with the valid byte counts
    int32[D]. Without a mesh fn(chunks u8[D*S], n_valid int32[D]) runs the
    D shards one after another on one device. With a mesh each rank passes
    its shard u8[S] and its count int32[1] (`shard_batch` of the flat
    array and the counts). Either returns
        (good bool[D], fallback bool[D], tail_start int32[D], QCStats)
    where good[d] = shard d validated; the stats sum the good shards only,
    and a shard whose bytes end at a record boundary reports tail_start ==
    n_valid[d]. The host re-parses rejected shards' byte ranges.

    `fallback` is always False (the port's ragged kernel takes every
    chunk), and `slot_cap`, the reference's slot capacity on the TPU, is
    accepted and not used."""
    from ..ops.ragged_qc import ragged_qc

    del slot_cap
    if mesh is not None:
        check_mesh(mesh, "build_ragged_qc_step")
    kw = dict(width=width, q_lo=int(schema.LOWER), q_hi=int(schema.UPPER),
              offset=int(schema.OFFSET), check_ascii=check_ascii,
              check_quality=check_quality)

    def one(chunk, n_valid):
        r = ragged_qc(chunk, int(n_valid), **kw)
        good = r.ok & ~r.fallback
        return good, r.fallback, r.tail_start, _masked(r.stats, good)

    if mesh is None:
        def step(chunks, n_valid):
            D = int(n_valid.shape[0])
            S = chunks.shape[0] // D
            goods, fbs, tails, sts = zip(*(
                one(chunks[d * S:(d + 1) * S], n_valid[d])
                for d in range(D)))
            return (torch.stack(goods), torch.stack(fbs), torch.stack(tails),
                    functools.reduce(stats_ops.QCStats.merge, sts))

        return step

    def step(chunk, n_valid):
        good, fb, tail, st = one(chunk, n_valid.reshape(-1)[0])
        mine = torch.stack([good.to(torch.int32), fb.to(torch.int32),
                            tail.to(torch.int32)])
        goods, fbs, tails = all_gather(
            mine[None], mesh.get_group(axis_name)).unbind(1)
        return (goods > 0, fbs > 0, tails,
                psum_tuple(mesh, st, (axis_name,)))

    return step
