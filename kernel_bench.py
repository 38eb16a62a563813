"""Device times of the port's kernels at the main paths' shapes, for one
source tree or several in turn.

    python3 kernel_bench.py [--tree DIR ...] [--seed N] [--ragged-path]
                            [--sweep]
                            [--only device_parse|merge|merge_kernel|cli_ops|
                                    kmer_k8|stage]

Each DIR (default: this script's directory) holds a `blazeseq_tpu_torch`
package; its kernels are built from its own sources and timed in a fresh
process, trees in the order given (pass parent, change, change, parent to
compare two commits on one card). Shapes:

* NW: 65,536 reads x 64 columns of length 40 against a 40 bp reference
  (the nw_gpu example) and 4,096 x 256 of length 150 against 150 bp (the
  QC batch of `run_file(align_to)`);
* the alignment variant kernel (`nw_variant_scores`) in each of its five
  modes at the same two shapes, beside its plain torch version
  (`plain_event_ms`: the wavefront's launches, timed with CUDA events); a
  tree without it skips it;
* kernel B: one 256 MiB chunk (760,440 records of 353 bytes) of the
  uniform corpus, and of the quality-binned one, through the raw launch
  (`_uniform_qc_raw_cuda`, without the torch epilogue);
* kernel A (`validate_decode`): 4,096 x 256 (the padded batch of
  `run_file`) and 32,768 x 1,024 (reads up to 1 kb, bound by device
  memory), inputs from `chip_smoke.kernel_a_inputs`;
* the scan kernel (`structural_bitmaps`): 256 MiB of the smoke's records
  and 64 MiB of bytes drawn from {'\\n', '@', '+', 'A'};
* the ragged kernels (`ragged_qc`, through the raw launch
  `_ragged_qc_raw_cuda`): 256 MiB of chip_smoke.py's ragged corpus at a
  256-column window, with the device memory one call allocates beyond the
  chunk (`scratch_bytes`) beside it, and the device time of the call's
  zero fill (in a tree whose ragged step starts with the scan kernel,
  that kernel's time); a tree without ops/ragged_qc.py skips it;
* the device-parse API on the same 256 MiB ragged chunk at device_parse's
  shape (3,121,343 rows x 300 columns): raw_stream_qc,
  newline_positions_device, record_offsets_device, gather_padded_device,
  parse_fastq_device and count_records_device, each with the device memory
  one call allocates at its peak beyond the chunk and what it returns
  (`scratch_bytes`), and raw_stream_qc + parse_fastq_device together as
  one chunk of the device_parse path (`device_parse_chunk`); raw_stream_qc,
  the compaction, the record pass and parse_fastq_device are first checked
  equal to their plain versions; in a tree without csrc/parse.cu these are
  its torch ops. `--only device_parse` times this section alone.

* the padded-batch panels at `run_file`'s 4,096 x 256 batch
  (chip_smoke.PANEL_SHAPE, inputs from chip_smoke.panel_inputs):
  `qc_stats` with the default options and with the quartile leaf (and at
  32,768 x 1,024 with it), `adapter_content` with chip_smoke's adapter,
  FastQC's six adapters (`adapters_6`: one `_adapter_contents` launch
  where the tree has it, else six calls), `read_hashes` (also at 32,768
  x 1,024, and into a sample buffer, `read_hashes_into_*`, where the tree
  has `_read_hashes_into`), and the whole padded step as `run_file`
  drives it (`build_qc_align_step` with alignment and quartiles, then the
  adapters and the hashes, adding into running totals where the tree
  keeps them, else merging; the hashes into a sample buffer where the
  tree has one, else a new tensor), with the chip_smoke adapter and with
  the six; the device time of an empty launch
  (`launch_floor_ms`); in a tree without the panel kernels these are its
  torch ops;
* the merge path (`merge`; `--only merge` times this section alone,
  `--only merge_kernel` only its first item): merge_pairs at the merge
  command's 4,096 x 256 batch and at MiSeq amplicon mates' 4,096 x 384
  (chip_smoke.MERGE_CARD_CASES; csrc/merge.cu, or a tree's torch loop)
  with their bounds, the profiler's CUDA kernel launches
  of one `merge` batch pair, `FastqBatch.to_padded`'s host ms on 4,096 x
  150 bp reads, the `merge` wall over chip_smoke.py's 250,000 pairs (with
  the sha256 of its output, to hold trees against each other) and the
  host ms of each step of a batch pair;
* the CLI's other device ops (`cli_ops`; `--only cli_ops` times this
  section alone): each call of chip_smoke.CLI_OP_TIMED (trim in its three
  modes, demux_assign, the per-tile sums, kmer_counts at k = 4) at the
  CLI's 4,096 x 256 (demux 16,384 x 256) batch of chip_smoke.py's 1M
  reads and at 32,768 x 1,024, card alone with its bound (the tiles
  kernel as its launch, or a tree's fill and launch, its whole call and
  its one PyTorch call, torch.mm of the one-hot tile matrix, beside it),
  checked equal to its plain version where the tree has one; the host ms
  of each step of a tiles call, its `bs.tiles.<step>` spans
  (`tiles_call_split_ms`); kmer_counts at k = 1, 4 and 8 on random and
  poly-G rows at 4,096 x 256, 65,536 x 256 and 32,768 x 1,024, and
  demux_assign on the 4 x 8, 8 x 48, 4,096 x 16 and 384 x 32 barcode
  sets at 16,384 x 256 ("refused" where the tree's kernel raises for the
  set), each beside its bound (`sets`); the launches of one call of each
  (as in `merge`); the walls of `trim` in three modes,
  `demux` and `tiles` on the 1M reads, twice each, with the sha256 of each
  command's stdout and output files;
* kmer_counts' costs (`--only kmer_k8`, this section alone): csrc/kmer.cu
  at k = 4 and 8, 4,096 x 256 and 32,768 x 1,024, built alone with
  switches that drop the other blocks' pieces, the rounds' cluster
  barriers or the flush, and with bin owners fixed at 1 to 64 (`_kmer_k8`);
* the feed's staging copy (`--only stage`, this section alone; no kernel
  is built): one 256 MiB chunk of a warm file (written just before, so the
  read is from the page cache) from a fresh read-only mapping, as
  `run_file_device` maps its file each call, into pinned memory, split
  into its page faults (`faults`: one byte a page read, on a fresh
  mapping) and its memcpy (`memcpy`: the copy again once every page is
  mapped), on one thread (`one_thread*`) and, where the tree has
  `parallel/ingest.py::stage_copy`, split over its threads (`split*`);
  beside them two alternatives on as many threads
  (`populate_then_split`: MADV_POPULATE_READ on each slice, then the
  copy; `pread_split`: each thread reads its slice of the file into
  pinned memory); each with the process's minor faults a chunk, and the
  host's usable cores (`_stage_split`);
* the CUDA kernel launches of one `run_file(align_to, adapters,
  duplicates, quartiles)` batch, from torch.profiler: the launches of
  runs over 1 and over 3 padded batches of chip_smoke's planted corpus,
  their difference over 2, and the kernels by name; again with FastQC's
  six adapters (`run_file_batch_launches_6_adapters`).

Each tree with `parallel/mesh.py` also compares a
1-rank NCCL mesh in its process with no mesh, each result equal to its
twin's: `build_uniform_qc_step` on the kernel B chunk above (times, and
a torch.profiler trace of three calls), and `QCModel.run_file` with
chip_smoke.py's run_file(align_to) options on its 1M x 150 bp corpus
(walls of single, mesh, mesh, single, and a trace of the 20,000-read
prefix). The traces' tables, sorted by self CPU time, go to
build/traces/mesh_{step,run_file}_{mesh,single}_<tree>.txt.

With --sweep, each tree whose `qc_stats` kernel takes a grid also times it
over rows a block (16-255, and its own choice) x cluster size (1-8) at
4,096 x 256 (default options and the quartile leaf) and 32,768 x 1,024
with the quartile leaf (`qc_stats_grid_sweep`).

With --ragged-path, each tree also drives `run_file_device` three times
over chip_smoke.py's 1 GiB ragged corpus (written anew in each tree's
process), each run checked against its numpy oracle and against
`run_file` on the same file (chip_smoke.phase_ragged), with the
`ragged_qc` launches of the first run.

Each kernel is checked equal to its plain version first. `device_ms`
queues the launches behind a sleeping kernel, so it is the card's time
alone; `event_ms` times back-to-back calls with CUDA events, host launch
cost included when the host is the slower side (both medians of 5 trials);
`host_ms` is their difference. Kernel A, the scan kernel, the ragged
kernels and the panels also carry `bound_ms` (chip_smoke.py's bound). Prints one JSON
line per tree, with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, inner, trials, queue):
    """Median ms per fn() call over `trials` CUDA-event timings of `inner`
    calls; with `queue`, the calls are enqueued behind a sleeping kernel
    so that the host's launch cost is hidden."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queue:
            torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, inner=10, trials=5):
    return _timed(fn, inner, trials, queue=True)


def event_ms(fn, inner=10, trials=5):
    return _timed(fn, inner, trials, queue=False)


def _times(fn, inner=10):
    d, e = device_ms(fn, inner), event_ms(fn, inner)
    return dict(device_ms=d, event_ms=e, host_ms=e - d)


def _same(got, want, label):
    import torch

    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("%s: kernel differs from plain" % label)


def _one_tree(tree, seed, ragged_path=False, sweep=False, only=None):
    # this script's chip_smoke (inputs and bounds; it imports the package
    # only inside its functions), then the tree's package
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from blazeseq_tpu_torch import _kernels, parse_schema
    from blazeseq_tpu_torch.ops import nw as nw_ops
    from blazeseq_tpu_torch.ops import scan
    from blazeseq_tpu_torch.ops import uniform_qc as uqc
    from blazeseq_tpu_torch.ops import validate
    from blazeseq_tpu_torch.ops.uniform_parse import detect_uniform_layout

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench.py needs a CUDA card")
    if only == "stage":
        return dict(tree=os.path.relpath(tree, HERE),
                    stage=_stage_split(seed))
    _kernels.load()
    out = dict(tree=os.path.relpath(tree, HERE),
               package=os.path.dirname(nw_ops.__file__))
    if only == "device_parse":
        out["device_parse"] = _device_parse(cs, seed)
        return out
    if only in ("merge", "merge_kernel"):
        out["merge"] = _merge(cs, seed, kernel_only=only == "merge_kernel")
        return out
    if only == "cli_ops":
        out["cli_ops"] = _cli_ops(cs, seed)
        return out
    if only == "kmer_k8":
        out["kmer_k8"] = _kmer_k8(cs, seed)
        return out
    rng = np.random.default_rng([seed, 3])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for label, B, Lq, Lr in (("nw_example", 65536, 64, 40),
                             ("nw_qc_batch", 4096, 256, 150)):
        d = [torch.from_numpy(a).cuda() for a in (
            rng.choice(acgt, (B, Lq)), np.full(B, Lr, np.int32),
            rng.choice(acgt, Lr))]
        _same((nw_ops.nw_scores(*d),), (nw_ops.nw_scores_torch(*d),), label)
        out[label] = _times(lambda: nw_ops.nw_scores(*d))
        if hasattr(nw_ops, "nw_variant_scores"):
            for mode, (_, plain, _) in nw_ops.VARIANT_MODES.items():
                vlabel = "%s_%s" % (label, mode)
                _same((nw_ops.nw_variant_scores(*d, mode),),
                      (getattr(nw_ops, plain)(*d),), vlabel)
                out[vlabel] = dict(
                    _times(lambda: nw_ops.nw_variant_scores(*d, mode)),
                    plain_event_ms=event_ms(
                        lambda: getattr(nw_ops, plain)(*d), inner=1,
                        trials=3),
                    bound_ms=cs.bound(
                        cs.nbytes(*d) + 4 * B,
                        cs.NW_VARIANT_OPS_PER_CELL[mode]
                        * cs._variant_cells(mode, d[1].cpu().numpy(), Lq,
                                            Lr))["bound_ms"])
    n = (256 << 20) // cs.RS
    for label, binned in (("uniform_qc", False), ("uniform_qc_binned", True)):
        rec, _ = cs._make_block(seed, 10 ** 6, 0, n, binned)
        lay = detect_uniform_layout(rec)
        c = torch.from_numpy(rec).cuda()
        kw = dict(rs=lay.rs, o1=lay.o1, o2=lay.o2, o3=lay.o3, cnt=cs.READ_LEN,
                  q_lo=33, q_hi=126, offset=33, check_ascii=True,
                  check_quality=True)
        _same(uqc._uniform_qc_raw_cuda(c, n, **kw),
              uqc._uniform_qc_raw_torch(c, n, **kw), label)
        out[label] = _times(lambda: uqc._uniform_qc_raw_cuda(c, n, **kw),
                            inner=5)
        del c
    schema = parse_schema("sanger")
    arng = np.random.default_rng([seed, 1])
    for n, L in cs.KERNEL_A_SHAPES:
        label = "validate_decode_%dx%d" % (n, L)
        seq, qual, lengths = cs.kernel_a_inputs(arng, n, L)
        d = [torch.from_numpy(a).cuda() for a in (seq, qual, lengths)]
        _same(validate.validate_decode(*d, schema),
              validate.validate_decode_torch(*d, schema.LOWER, schema.UPPER,
                                             schema.OFFSET), label)
        out[label] = dict(_times(lambda: validate.validate_decode(*d, schema)),
                          bound_ms=cs.kernel_a_bound(lengths, L)["bound_ms"])
        del d
    rec, _ = cs._make_block(seed, 10 ** 6 + 1, 0, cs.PARSE_CHUNK // cs.RS,
                            False)
    soup = np.random.default_rng([seed, 5]).choice(
        np.frombuffer(b"\n@+A", np.uint8), 64 << 20)
    for label, host in (("structural_bitmaps_records", rec.reshape(-1)),
                        ("structural_bitmaps_soup", soup)):
        c = scan._pad_lane(torch.from_numpy(host).cuda())
        got = scan.structural_bitmaps(c)
        _same(got, scan.structural_bitmaps_torch(c), label)
        out[label] = dict(_times(lambda: scan.structural_bitmaps(c)),
                          bound_ms=cs.bound(cs.nbytes(c, *got),
                                            3 * c.numel() // 4)["bound_ms"])
        del c, got
    out.update(_panels(cs, seed))
    if sweep:
        out["qc_stats_grid_sweep"] = _qc_stats_sweep(cs, seed)
    out["run_file_batch_launches"] = _batch_launches(cs, seed)
    out["run_file_batch_launches_6_adapters"] = _batch_launches(
        cs, seed, cs.FASTQC_ADAPTERS)
    out["device_parse"] = _device_parse(cs, seed)
    out["merge"] = _merge(cs, seed)
    if importlib.util.find_spec("blazeseq_tpu_torch.ops.ragged_qc"):
        out["ragged_qc"] = _ragged(cs, seed)
        if ragged_path:
            out["run_file_device_ragged"] = _ragged_path(cs, seed)
    if importlib.util.find_spec("blazeseq_tpu_torch.parallel.mesh"):
        out.update(_mesh(cs, seed, out["tree"]))
    return out


def _leaves(st):
    return [x for x in st if x is not None]


def _panels(cs, seed):
    """The padded-batch panels and the padded step at cs.PANEL_SHAPE
    (qc_stats also at cs.PANEL_WIDE with the quartile leaf); each kernel
    checked equal to its plain version where the tree has one."""
    import numpy as np
    import torch

    from blazeseq_tpu_torch import parse_schema
    from blazeseq_tpu_torch.ops import adapter as ad
    from blazeseq_tpu_torch.ops import dedup, stats
    from blazeseq_tpu_torch.parallel import build_qc_align_step

    out = {}
    rng = np.random.default_rng([seed, 7])
    for n, L in (cs.PANEL_SHAPE, cs.PANEL_WIDE):
        seq, qual, lengths, codes = cs.panel_inputs(rng, n, L)
        d = [torch.from_numpy(a).cuda() for a in (seq, qual, lengths, codes)]
        for q2 in (False, True) if (n, L) == cs.PANEL_SHAPE else (True,):
            label = "qc_stats_%dx%d%s" % (n, L, "_2d" if q2 else "")

            def call(fn=stats.qc_stats, q2=q2):
                return fn(d[0], d[1], d[2], 33, n_records=n,
                          error_codes=d[3], qual_hist_2d=q2)

            if hasattr(stats, "qc_stats_torch"):
                _same(_leaves(call()), _leaves(call(stats.qc_stats_torch)),
                      label)
            out[label] = dict(_times(call), bound_ms=cs.qc_stats_bound(
                lengths, L, n, q2)["bound_ms"])
        label = "read_hashes_%dx%d" % (n, L)
        hbound = cs.hash_bound(lengths, L, n, n)["bound_ms"]
        if hasattr(dedup, "read_hashes_torch"):
            _same((dedup.read_hashes(d[0], d[2], n),),
                  (dedup.read_hashes_torch(d[0], d[2], n),), label)
        out[label] = dict(_times(lambda: dedup.read_hashes(d[0], d[2], n)),
                          bound_ms=hbound)
        if hasattr(dedup, "_read_hashes_into"):
            # the call run_parser makes: into rows of its sample buffer
            sample = torch.empty((2 * n, 2), dtype=torch.int64,
                                 device="cuda")
            out["read_hashes_into_%dx%d" % (n, L)] = dict(_times(
                lambda: dedup._read_hashes_into(d[0], d[2], n, sample, n,
                                                n)), bound_ms=hbound)
        if (n, L) != cs.PANEL_SHAPE:
            continue
        label = "adapter_content_%dx%d" % (n, L)

        def adapter(fn=ad.adapter_content):
            return fn(d[0], d[2], n, adapter_host=cs.ADAPTER)

        if hasattr(ad, "adapter_content_torch"):
            _same(adapter(), adapter(ad.adapter_content_torch), label)
        out[label] = dict(_times(adapter), bound_ms=cs.adapter_bound(
            d[0], d[2], n, (cs.ADAPTER,))["bound_ms"])
        # FastQC's six adapters: one launch where the tree scans them
        # together, else one call an adapter
        six = cs.FASTQC_ADAPTERS
        if hasattr(ad, "_adapter_contents"):
            def adapters6():
                return ad._adapter_contents(d[0], d[2], n, six)
        else:
            def adapters6():
                return [ad.adapter_content(d[0], d[2], n, adapter_host=a)
                        for a in six]
        for a, g in zip(six, adapters6()):
            _same(g, ad.adapter_content_torch(d[0], d[2], n, adapter_host=a)
                  if hasattr(ad, "adapter_content_torch") else g,
                  label + " " + a.decode())
        out["adapters_6_%dx%d" % (n, L)] = dict(
            _times(adapters6),
            bound_ms=cs.adapter_bound(d[0], d[2], n, six)["bound_ms"])
        kw = cs._align_kw(seed)
        ref = torch.from_numpy(np.frombuffer(kw["align_to"], np.uint8)
                               .copy()).cuda()
        step = build_qc_align_step(with_alignment=True, qual_hist_2d=True)
        sanger = parse_schema("sanger")
        # the step as run_file drives it: into running totals where the
        # tree keeps them (one launch for the adapters), else a merge
        totals = {}
        sample = torch.empty((2 * n, 2), dtype=torch.int64, device="cuda")

        def padded_step(adapters=(cs.ADAPTER,)):
            if hasattr(ad, "_adapter_contents"):
                st = totals.get("stats")
                totals["stats"] = step(d[0], d[1], d[2], n, sanger, ref,
                                       out=st).stats
                totals[adapters] = ad._adapter_contents(
                    d[0], d[2], n, adapters, out=totals.get(adapters))
            else:
                st = step(d[0], d[1], d[2], n, sanger, ref).stats
                totals["stats"] = (st if "stats" not in totals
                                   else totals["stats"].merge(st))
                for a in adapters:
                    ast = ad.adapter_content(d[0], d[2], n, adapter_host=a)
                    totals[a] = (ast if a not in totals
                                 else totals[a].merge(ast))
            # the hashes into the duplication sample where the tree keeps
            # one, else a new tensor a batch
            if hasattr(dedup, "_read_hashes_into"):
                dedup._read_hashes_into(d[0], d[2], n, sample, n, n)
            else:
                dedup.read_hashes(d[0], d[2], n)

        out["padded_step_%dx%d" % (n, L)] = _times(padded_step, inner=5)
        out["padded_step_6_adapters_%dx%d" % (n, L)] = _times(
            lambda: padded_step(six), inner=5)
    out["launch_floor_ms"] = cs.launch_floor_ms()
    return out


def _qc_stats_sweep(cs, seed):
    """qc_stats' device ms by (rows a block, cluster size) at cs.PANEL_SHAPE
    (default options, and the quartile leaf) and at cs.PANEL_WIDE with the
    quartile leaf, into a running total; "0x0" is the kernel's own choice,
    timed first and again last ("0x0_again"). Empty where the tree's
    kernel takes no grid."""
    import inspect

    import numpy as np
    import torch

    from blazeseq_tpu_torch.ops import stats

    if "rows_per_block" not in inspect.signature(
            stats._qc_stats_cuda).parameters:
        return {}
    out = {}
    rng = np.random.default_rng([seed, 7])
    for (n, L), q2s in ((cs.PANEL_SHAPE, (False, True)),
                        (cs.PANEL_WIDE, (True,))):
        d = [torch.from_numpy(a).cuda() for a in cs.panel_inputs(rng, n, L)]
        for q2 in q2s:
            total = stats.qc_stats(d[0], d[1], d[2], 33, qual_hist_2d=q2)
            row = {}
            # the kernel's own choice first and again last: a card that
            # slowed down during the sweep shows as a difference
            for rows, cluster in ((0, 0), *((r, c) for r in (16, 32, 64, 128,
                                                              255)
                                            for c in (1, 2, 4, 8)), (0, 0)):
                key = "%dx%d" % (rows, cluster)
                row[key + "_again" if key in row else key] = device_ms(
                    lambda: stats._qc_stats_cuda(
                        d[0], d[1], d[2], 33, n, d[3], 0, True, True, q2,
                        total, rows, cluster))
            out["qc_stats_%dx%d%s" % (n, L, "_2d" if q2 else "")] = row
        del d
    return out


def _batch_launches(cs, seed, adapters=None):
    """CUDA kernel launches of run_file(align_to, adapters, duplicates,
    quartiles) on 1 and on 3 padded batches of chip_smoke's planted corpus,
    from torch.profiler (each run after a warm-up run of the same model);
    per batch, their difference over 2, with the kernels by name. Copies
    (Memcpy / Memset) are counted apart. `adapters` replaces chip_smoke's
    one adapter."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blazeseq_tpu_torch import QCModel
    from blazeseq_tpu_torch.constants import DEFAULT_BATCH_SIZE

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k in (1, 3):
            path = os.path.join(tmp, "batches%d.fastq" % k)
            cs.write_corpus(path, DEFAULT_BATCH_SIZE * k, seed + 17,
                            planted=True)
            kw = cs._align_kw(seed)
            if adapters is not None:
                kw["adapters"] = list(adapters)
            model = QCModel(device="cuda", **kw)
            model.run_file(path)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model.run_file(path)
                torch.cuda.synchronize()
            runs[k] = collections.Counter(
                e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA)

    def split(c):
        copies = sum(v for k, v in c.items() if k.startswith("Mem"))
        return sum(c.values()) - copies, copies

    (k1, c1), (k3, c3) = split(runs[1]), split(runs[3])
    diff = runs[3].copy()
    diff.subtract(runs[1])
    return dict(one_batch=dict(kernels=k1, copies=c1),
                three_batches=dict(kernels=k3, copies=c3),
                kernels_per_batch=(k3 - k1) / 2,
                copies_per_batch=(c3 - c1) / 2,
                per_batch_by_name={k: v / 2 for k, v in sorted(diff.items())
                                   if v})


def _trace(fn, tree, name):
    """One torch.profiler trace of fn(); its table (sorted by self CPU
    time) goes to build/traces/<name>_<tree>.txt, whose path is
    returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join("build", "traces", "%s_%s.txt" % (
        name, tree.replace(os.sep, "_").strip("._") or "here"))
    os.makedirs(os.path.dirname(os.path.join(HERE, path)), exist_ok=True)
    with open(os.path.join(HERE, path), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    return path


def _mesh(cs, seed, tree):
    """A 1-rank NCCL mesh in this process against no mesh, each result
    equal to its twin's: build_uniform_qc_step on one 256 MiB uniform
    chunk (times, and a trace of three calls), and QCModel.run_file with
    chip_smoke's run_file(align_to) options on its 1M x 150 bp corpus
    (walls of single, mesh, mesh, single, and a trace of the 20,000-read
    prefix)."""
    import time

    import torch
    import torch.distributed as dist

    from blazeseq_tpu_torch import QCModel, parse_schema
    from blazeseq_tpu_torch.ops.uniform_parse import detect_uniform_layout
    from blazeseq_tpu_torch.parallel import (build_uniform_qc_step,
                                             make_mesh, shard_batch)

    n = (256 << 20) // cs.RS
    rec, _ = cs._make_block(seed, 10 ** 6, 0, n, False)
    lay = detect_uniform_layout(rec)
    sanger = parse_schema("sanger")
    mesh = make_mesh(1)
    step_out, file_out = {}, {}
    try:
        (chunk,) = shard_batch(mesh, rec)
        steps = dict(
            mesh=build_uniform_qc_step(mesh, lay, sanger, width=cs.QC_WIDTH),
            single=build_uniform_qc_step(None, lay, sanger,
                                         width=cs.QC_WIDTH))
        got, want = (steps[k](chunk, rec.size) for k in ("mesh", "single"))
        _same([x for x in (*got[:3], *got[3]) if x is not None],
              [x for x in (*want[:3], *want[3]) if x is not None],
              "build_uniform_qc_step(mesh)")
        for label, step in steps.items():
            step_out[label] = dict(
                _times(lambda: step(chunk, rec.size), inner=5),
                trace=_trace(lambda: [step(chunk, rec.size)
                                      for _ in range(3)],
                             tree, "mesh_step_" + label))
        del chunk

        kw = cs._align_kw(seed)
        meshes = dict(single=None, mesh=mesh)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "align.fastq")
            prefix = os.path.join(tmp, "prefix.fastq")
            cs.write_corpus(path, cs.ALIGN_READS, seed + 17, planted=True)
            with open(path, "rb") as f, open(prefix, "wb") as g:
                g.write(f.read(cs.ALIGN_PREFIX_READS * cs.RS))
            reports = {}
            for label in ("single", "mesh", "mesh", "single"):
                model = QCModel(device="cuda", mesh=meshes[label], **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reports[label] = model.run_file(path)
                torch.cuda.synchronize()
                file_out.setdefault(label, dict(wall_s=[]))["wall_s"].append(
                    time.perf_counter() - t0)
            cs._same_reports(reports["mesh"], reports["single"],
                             "QCModel(mesh, 1 rank).run_file vs one device")
            for label, m in meshes.items():
                model = QCModel(device="cuda", mesh=m, **kw)
                file_out[label]["trace"] = _trace(
                    lambda: model.run_file(prefix), tree,
                    "mesh_run_file_" + label)
    finally:
        dist.destroy_process_group()
    return dict(uniform_qc_step=step_out, run_file_align=file_out)


def _ragged_path(cs, seed, repeats=3):
    """chip_smoke's run_file_device(ragged) path in this process, `repeats`
    times on one corpus: each run's GB/s, run_file's on the same file, and
    the ragged_qc launches of the first run."""
    from blazeseq_tpu_torch.ops import ragged_qc

    with tempfile.TemporaryDirectory() as tmp:
        corpus = cs.make_ragged_corpus(seed, tmp)
        runs = []
        for _ in range(repeats):
            ragged_qc.launches = 0
            runs.append(dict(cs.phase_ragged(corpus),
                             ragged_qc_launches=ragged_qc.launches))
    return dict(runs[0], gbps_runs=[r["gbps"] for r in runs],
                host_gbps_runs=[r["host_gbps"] for r in runs])


def _device_parse(cs, seed):
    """The device-parse calls on one 256 MiB chunk of the ragged corpus:
    card-alone ms and scratch bytes of each, the kernels checked equal to
    their plain versions where the tree has both."""
    import numpy as np
    import torch

    from blazeseq_tpu_torch.ops import raw_stats, scan

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ragged.fastq")
        cs.write_ragged_corpus(path, cs.PARSE_CHUNK, seed + 23)
        c = torch.from_numpy(np.fromfile(path, np.uint8)).cuda()
    mr = cs.PARSE_CHUNK // cs.RAGGED_MIN_RECORD + 1
    ml = cs.RAGGED_LEN[1]
    offsets = scan.record_offsets_device(c, mr)[0]
    calls = dict(
        raw_stream_qc=lambda: raw_stats.raw_stream_qc(c, 33, 126, 33),
        newline_positions=lambda: scan.newline_positions_device(c, 4 * mr),
        record_offsets=lambda: scan.record_offsets_device(c, mr),
        gather_padded=lambda: scan.gather_padded_device(c, offsets, mr, ml),
        parse_fastq=lambda: scan.parse_fastq_device(c, mr, ml),
        count_records=lambda: (scan.count_records_device(c),),
        device_parse_chunk=lambda: (*raw_stats.raw_stream_qc(c, 33, 126, 33),
                                    *scan.parse_fastq_device(c, mr, ml)))
    if hasattr(scan, "record_offsets_torch"):
        _same(calls["raw_stream_qc"](),
              raw_stats.raw_stream_qc_torch(c, 33, 126, 33), "raw_stream_qc")
        _same(calls["newline_positions"](),
              scan.newline_positions_torch(c, 4 * mr), "newline_positions")
        _same(calls["record_offsets"](), scan.record_offsets_torch(c, mr),
              "record_offsets")
        _same(calls["parse_fastq"](),
              (*scan.gather_padded_torch(c, offsets, mr, ml),
               *scan.record_offsets_torch(c, mr)[1:]), "parse_fastq")
    out = dict(bytes=c.numel(), max_records=mr, max_len=ml)
    for name, fn in calls.items():
        out[name] = dict(device_ms=device_ms(fn, inner=3, trials=3),
                         scratch_bytes=cs.call_scratch_bytes(fn))
    return out


def _profiled(fn):
    """fn() under torch.profiler, after the card has finished what was
    queued before: (CUDA kernel launches, copies and fills (Memcpy /
    Memset), the kernels by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events()
                                if e.device_type == DeviceType.CUDA)
    copies = sum(v for k, v in names.items() if k.startswith("Mem"))
    return sum(names.values()) - copies, copies, names


def _cli_run(argv):
    """The port's CLI in this process on the card: (the wall in seconds,
    its stdout)."""
    import contextlib
    import io
    import time

    import torch

    from blazeseq_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv, device="cuda")
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError("cli %s: exit %d" % (argv[0], rc))
    return time.perf_counter() - t0, buf.getvalue()


def _merge_split(cs, r1, r2, repeats=10):
    """Host ms of each step of one merge batch pair as the merge command
    runs it (the first MERGE_BATCH pairs of r1 and r2, medians over
    `repeats`): parse both batches from memory, to_padded both, upload
    both, merge_pairs, read merged_len / seq / qual back, serialise. Each
    step that queues work on the card ends in a synchronize."""
    import statistics
    import time

    import numpy as np
    import torch

    import blazeseq_tpu_torch as bt
    from blazeseq_tpu_torch.fastq.batch import (padded_to_device,
                                                serialize_fastq_rows)
    from blazeseq_tpu_torch.ops import merge

    data = []
    for path in (r1, r2):
        with open(path, "rb") as f:
            data.append(f.read(cs.MERGE_BATCH * 512))
    state = {}

    def parse():
        state["b"] = [bt.FastqParser(bt.MemoryReader(x)).next_batch(
            cs.MERGE_BATCH) for x in data]

    def pad():
        w = max(int(np.diff(b._ends, prepend=0).max()) for b in state["b"])
        state["pb"] = [b.to_padded(max_len=w) for b in state["b"]]

    def upload():
        state["d"] = [padded_to_device(pb, "cuda") for pb in state["pb"]]
        torch.cuda.synchronize()

    def run():
        (p1, p2) = state["d"]
        state["res"] = merge.merge_pairs(p1.seq, p1.qual, p1.lengths,
                                         p2.seq, p2.qual, p2.lengths)
        torch.cuda.synchronize()

    def read_back():
        n = state["d"][0].n_records
        res = state["res"]
        state["host"] = (res.merged_len.cpu().numpy()[:n],
                         res.seq.cpu().numpy()[:n],
                         res.qual.cpu().numpy()[:n])

    def serialise():
        b1 = state["b"][0]
        lens, seq, qual = state["host"]
        serialize_fastq_rows(b1._id_bytes, b1._id_ends, seq, qual, lens)

    steps = dict(parse=parse, to_padded=pad, upload=upload,
                 merge_pairs=run, read_back=read_back, serialise=serialise)
    times = {k: [] for k in steps}
    for _ in range(repeats + 1):
        for name, fn in steps.items():
            t0 = time.perf_counter()
            fn()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v[1:]) for k, v in times.items()}


# the merge kernel's timed shapes: the merge command's batch and MiSeq
# amplicon mates (chip_smoke.MERGE_CARD_CASES)
MERGE_SHAPES = ("the merge command's batch, 4,096 x 256",
                "MiSeq 2 x 300, 4,096 x 384")


def _merge(cs, seed, kernel_only=False):
    """The merge path: merge_pairs' card-alone time at the merge command's
    4,096 x 256 batch and at 4,096 x 384 (MERGE_SHAPES) with their bounds
    (with kernel_only, nothing else); the profiler's CUDA kernel launches
    of one merge batch pair (the command over 1 and 3 batch pairs, their
    difference over 2); to_padded's host ms
    on 4,096 x 150 bp reads; the merge wall over chip_smoke.py's 250,000
    pairs, with the sha256 of its stdout and output (_cli_hashed); and the
    host ms of each step of a merge batch pair (_merge_split). The other
    CLI commands are `cli_ops`'."""
    import statistics
    import time

    import torch

    from blazeseq_tpu_torch.fastq.parser import FastqParser
    from blazeseq_tpu_torch.io.readers import open_reader
    from blazeseq_tpu_torch.ops import merge

    out = {}
    for label in MERGE_SHAPES:
        arrays, _ = cs.merge_edge_case(label, seed)
        d = [torch.from_numpy(a).cuda() for a in arrays]
        if hasattr(merge, "merge_pairs_torch"):
            _same(merge.merge_pairs(*d), merge.merge_pairs_torch(*d),
                  "merge_pairs " + label)
        key = "merge_pairs" if label == MERGE_SHAPES[0] else (
            "merge_pairs_%dx%d" % tuple(arrays[0].shape))
        out[key] = dict(
            _times(lambda: merge.merge_pairs(*d), inner=3),
            bound_ms=cs.merge_bound(arrays[2], arrays[5],
                                    arrays[0].shape[1])["bound_ms"])
        del d
    if kernel_only:
        return out
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for k in (1, 3):
            r1, r2 = (os.path.join(tmp, "r%d_%d.fastq" % (m, k))
                      for m in (1, 2))
            cs.write_mates(r1, r2, cs.MERGE_BATCH * k, seed)
            argv = ["merge", "--out", os.path.join(tmp, "m.fastq"), r1, r2]
            _cli_run(argv)  # warm-up
            runs[k] = _profiled(lambda: _cli_run(argv))
        diff = runs[3][2].copy()
        diff.subtract(runs[1][2])
        out["merge_batch_pair_launches"] = dict(
            kernels_per_batch_pair=(runs[3][0] - runs[1][0]) / 2,
            copies_per_batch_pair=(runs[3][1] - runs[1][1]) / 2,
            by_name={k: v / 2 for k, v in sorted(diff.items()) if v})
        b = FastqParser(open_reader(r1)).next_batch(cs.MERGE_BATCH)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            b.to_padded(max_len=cs.READ_LEN)
            times.append(1e3 * (time.perf_counter() - t0))
        out["to_padded_host_ms"] = dict(
            reads=b.num_records(), read_len=cs.READ_LEN,
            median=statistics.median(times), min=min(times))
        r1, r2 = (os.path.join(tmp, x) for x in ("r1.fastq", "r2.fastq"))
        cs.write_mates(r1, r2, cs.MATE_PAIRS, seed)
        wall, sha = _cli_hashed(["merge", "--out", os.path.join(
            tmp, "out", "m.fastq"), r1, r2], os.path.join(tmp, "out"))
        out["cli_walls"] = {"merge": dict(wall_s=wall, sha256=sha)}
        out["merge_batch_pair_split_ms"] = _merge_split(cs, r1, r2)
    return out


def _cli_op_launches(cs, reads):
    """torch.profiler's CUDA kernel launches and copies of one call of each
    CLI device op (trim's three modes, kmer_counts, the per-tile sums,
    demux_assign) on the first 4,096 reads of `reads` as the CLI pads them
    (to 256 columns for 150 bp reads)."""
    from blazeseq_tpu_torch.ops import demux, kmer, tiles, trim

    tl, seq, qual, lengths, n_records = cs.cli_file_batch(reads, 4096)
    ops = dict(
        trim_window=lambda: trim.sliding_window_trim(qual, lengths, 33, 15,
                                                     window=4),
        trim_bwa=lambda: trim.bwa_trim(qual, lengths, 33, 20),
        trim_ends=lambda: trim.clip_ends(qual, lengths, 33),
        kmer=lambda: kmer.kmer_counts(seq, lengths, k=4),
        tiles=lambda: tiles.PerTileAccumulator().add_batch(
            tl, qual, lengths, 33, n_records=n_records),
        demux=lambda: demux.demux_assign(seq, lengths, cs.DEMUX_BARCODES, 1))
    launches = {}
    for name, fn in ops.items():
        fn()
        k, c, names = _profiled(fn)
        launches[name] = dict(kernels=k, copies=c, by_name=dict(names))
    return launches


def _tiles_split(cs, head, repeats=20):
    """Host ms of one per_tile_qual_sums call on the card (the first 4,096
    reads of the 1M-read file as the CLI pads them), medians over
    `repeats`: the whole call, timed with tracing off, and, in a tree whose
    call opens a span a step (`bs.tiles.<step>`, read from
    tracing.capture()), each step as the call itself runs it, from repeats
    of their own under capture() (whose bookkeeping the whole call would
    otherwise pay), with no synchronize added (the launch and the copies
    only queue their work; `download` is the copy that ends the call)."""
    import statistics
    import time

    from blazeseq_tpu_torch import tracing
    from blazeseq_tpu_torch.ops import tiles

    tl, _, qual, lengths, n_records = head

    def call():
        tiles.per_tile_qual_sums(tl, qual, lengths, 33, n_records=n_records)

    times = {}
    for _ in range(repeats + 1):
        t0 = time.perf_counter()
        call()
        times.setdefault("whole_call", []).append(
            1e3 * (time.perf_counter() - t0))
    capture = getattr(tracing, "capture", None)
    prefix = "bs.tiles."
    for _ in range(repeats + 1 if capture else 0):
        with capture() as tr:
            before = dict(tr.times)
            call()
        for name, t in tr.times.items():
            if name.startswith(prefix):
                times.setdefault(name[len(prefix):], []).append(
                    1e3 * (t - before.get(name, 0.0)))
    return {name: statistics.median(v[1:]) for name, v in times.items()}


# kmer_counts' ks and shapes (the CLI's, the analysis path's and reads up
# to 1 kb), on random and on poly-G rows, and demux_assign's sets at its
# 16,384 x 256 batch: chip_smoke.DEMUX_CARD_SETS and 384 x 32
KMER_BENCH_KS = (1, 4, 8)
KMER_BENCH_SHAPES = ((4096, 256), (65536, 256), (32768, 1024))
DEMUX_BENCH_SHAPE = (16384, 256)


def _cli_op_sets(cs, seed):
    """Card-alone ms of kmer_counts at KMER_BENCH_KS on KMER_BENCH_SHAPES
    (random rows, chip_smoke.cli_op_card_batch, and the same rows all G)
    and of demux_assign (max_mismatches 1) on each barcode set at
    DEMUX_BENCH_SHAPE, each beside its bound and checked equal to its
    plain version; "refused" where the tree's kernel raises ValueError for
    the set."""
    import numpy as np

    from blazeseq_tpu_torch.ops import demux, kmer

    out = {}
    for n, L in KMER_BENCH_SHAPES:
        arrays = cs.cli_op_card_batch("kmer", n, L, seed)
        poly = dict(arrays, seq=np.full_like(arrays["seq"], ord("G")))
        for rows, host in (("random", arrays), ("poly-G", poly)):
            d = cs.cli_op_tensors(host, "cuda")
            for k in KMER_BENCH_KS:
                def call(k=k):
                    return kmer.kmer_counts(d["seq"], d["lengths"], k=k)
                _same((call(),), (kmer.kmer_counts_torch(
                    d["seq"], d["lengths"], k=k),), "kmer k=%d" % k)
                out["kmer_k%d_%dx%d_%s" % (k, n, L, rows)] = dict(
                    device_ms=device_ms(call),
                    **cs.cli_op_bound("kmer", host, k=k))
            del d
    n, L = DEMUX_BENCH_SHAPE
    sets = [(name, bcs) for name, bcs, _ in cs.DEMUX_CARD_SETS]
    sets.append(("384 x 32", tuple(cs.barcode_set(384, 32))))
    for name, bcs in sets:
        host = cs.cli_op_card_batch("demux", n, L, seed, bcs)
        d = cs.cli_op_tensors(host, "cuda")

        def call(bcs=bcs):
            return demux.demux_assign(d["seq"], d["lengths"], bcs, 1)
        rec = dict(cs.cli_op_bound("demux", host, barcodes=bcs))
        try:
            got = call()
        except ValueError as e:
            rec.update(device_ms="refused", error=str(e))
        else:
            _same(got, demux.demux_assign_torch(d["seq"], d["lengths"], bcs,
                                                1), "demux %s" % name)
            rec["device_ms"] = device_ms(call)
        out["demux_%s_%dx%d" % (name.replace(",", "").replace(" ", ""), n,
                                L)] = rec
        del d
    return out


# --only stage: the chunk the throughput corpus's uniform tier stages,
# 256 MiB cut to whole 219-byte records; the rows that copy a whole chunk
STAGE_CHUNK = (256 << 20) // 219 * 219
COPIES = ("one_thread", "one_thread_memcpy", "split", "split_memcpy",
          "populate_then_split", "pread_split")


def _stage_split(seed, trials=7):
    """Wall ms, GB/s and minor faults (getrusage, every thread) of one
    STAGE_CHUNK's staging copy into pinned memory from a fresh read-only
    mapping (the tree's MmapReader) of a warm file, and of its parts (see
    the module docstring); medians of `trials`."""
    import resource
    import statistics
    import time
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from blazeseq_tpu_torch.io.readers import MmapReader
    from blazeseq_tpu_torch.parallel import ingest

    n = STAGE_CHUNK
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
    pinned[:] = 0  # every page of the destination mapped before timing
    split = getattr(ingest, "stage_copy", None)
    threads = (ingest._stage_threads() if split
               else min(len(os.sched_getaffinity(0)), 8))
    pool = ThreadPoolExecutor(threads)
    step = -(-n // (threads * 4096)) * 4096

    def touch(k):
        # one read a page, on k threads, faults each page in (the kernel
        # maps its neighbours in the page cache with it, as in a copy)
        step = -(-n // (k * 4096)) * 4096

        def run(src, _mm):
            return max(pool.map(lambda a: int(src[a:a + step:4096].max()),
                                range(0, n, step)))
        return run

    def populate(src, mm):
        # the alternatives: the kernel maps each thread's slice in one call
        # (MADV_POPULATE_READ, Linux 5.14), then the split copy; or each
        # thread reads its slice from the file into pinned memory
        list(pool.map(lambda a: mm.madvise(22, a, min(step, n - a)),
                      range(0, n, step)))
        list(pool.map(lambda a: np.copyto(pinned[a:a + step],
                                          src[a:a + step]),
                      range(0, n, step)))

    def pread(_src, _mm):
        fd = os.open(path, os.O_RDONLY)
        try:
            list(pool.map(lambda a: os.preadv(fd, [pinned[a:a + step]], a),
                          range(0, n, step)))
        finally:
            os.close(fd)

    def timed(fn, src, mm):
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        t0 = time.perf_counter()
        fn(src, mm)
        t1 = time.perf_counter()
        return (t1 - t0) * 1e3, \
            resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0

    def one(src, _mm):
        np.copyto(pinned, src)

    def par(src, _mm):
        used = split(pinned, src)
        if used != threads:
            raise AssertionError("stage_copy took %d threads of %d"
                                 % (used, threads))

    plans = {"one_thread": [("one_thread", one)],
             "one_thread_parts": [("one_thread_faults", touch(1)),
                                  ("one_thread_memcpy", one)]}
    if split:
        plans["split"] = [("split", par)]
        plans["split_parts"] = [("split_faults", touch(threads)),
                                ("split_memcpy", par)]
    plans["populate_then_split"] = [("populate_then_split", populate)]
    plans["pread_split"] = [("pread_split", pread)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "chunk.bin")
        want = np.random.default_rng([seed, 11]).integers(
            0, 256, n, dtype=np.uint8)
        want.tofile(path)
        rows = collections.defaultdict(list)
        out_err = {}
        for _ in range(trials):
            for plan in plans.values():
                reader = MmapReader(path)  # a fresh mapping
                src = reader.as_array()[:n]
                for name, fn in plan:
                    pinned[:] = 0
                    try:
                        ms, flt = timed(fn, src, reader._mm)
                    except OSError as e:  # an alternative the host lacks
                        out_err[name] = repr(e)
                        continue
                    if name in COPIES and not np.array_equal(pinned, want):
                        raise AssertionError("%s: staged bytes differ"
                                             % name)
                    rows[name].append((ms, flt))
                del src, reader
    pool.shutdown()
    out = dict(chunk_bytes=n, threads=threads, trials=trials,
               usable_cores=len(os.sched_getaffinity(0)),
               cpu_count=os.cpu_count(), errors=out_err)
    for name, got in rows.items():
        ms = statistics.median(m for m, _ in got)
        out[name] = dict(ms=ms, gb_per_s=n / ms / 1e6,
                         ms_range=[min(m for m, _ in got),
                                   max(m for m, _ in got)],
                         minor_faults=statistics.median(f for _, f in got))
    return out


# --only kmer_k8: csrc/kmer.cu built alone with its measurement switches
# (name, BS_KMER_SKIP, BS_KMER_OWNERS); the owner counts of the sweep
KMER_SWITCHES = (("library", 0, 0), ("skip_other_pieces", 1, 0),
                 ("skip_round_barriers", 2, 0), ("skip_flush", 4, 0),
                 ("skip_all", 7, 0))
KMER_OWNERS = (1, 2, 4, 8, 16, 32, 64)
KMER_K8_SHAPES = ((4096, 256), (32768, 1024))


def _kmer_k8(cs, seed):
    """Card-alone ms of csrc/kmer.cu at k = 4 and 8 on KMER_K8_SHAPES
    (random rows, chip_smoke.cli_op_card_batch), built alone once a
    KMER_SWITCHES entry (the switches that drop work leave the counts
    wrong) and once an owner count of KMER_OWNERS (bin owners: blocks at k
    = 4, clusters of 2 blocks at k = 8), every build but the dropping ones
    checked equal to the plain version first. Each build is one nvcc, all
    started together."""
    import ctypes

    import torch

    from blazeseq_tpu_torch import _kernels
    from blazeseq_tpu_torch.ops import kmer

    builds = [(name, skip, 0) for name, skip, _ in KMER_SWITCHES]
    builds += [("owners_%d" % o, 0, o) for o in KMER_OWNERS]
    src = os.path.join(_kernels.CSRC, "kmer.cu")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="kmer_k8_", dir=os.path.join(HERE,
                                                                "build"))
    procs = {}
    for name, skip, owners in builds:
        so = os.path.join(tmp, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-shared",
             "-DBS_KMER_SKIP=%d" % skip, "-DBS_KMER_OWNERS=%d" % owners,
             src, "-o", so], stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError("nvcc %s: %s" % (name, proc.stderr.read()))
        lib = ctypes.CDLL(so)
        lib.bs_kmer_counts.argtypes = _kernels._SIGNATURES["bs_kmer_counts"]
        lib.bs_kmer_counts.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda", torch.cuda.current_device())
    state = torch.zeros(2, dtype=torch.int64, device=dev)
    sms = _kernels.sm_count(0)
    out = {}
    for n, L in KMER_K8_SHAPES:
        d = cs.cli_op_tensors(cs.cli_op_card_batch("kmer", n, L, seed),
                              "cuda")
        for k in (4, 8):
            want = kmer.kmer_counts_torch(d["seq"], d["lengths"], k=k)
            bins = torch.empty(4 ** k, dtype=torch.int32, device=dev)
            for (name, skip, _), lib in zip(builds, libs.values()):
                def call(lib=lib):
                    _kernels.check(lib.bs_kmer_counts(
                        d["seq"].data_ptr(), d["lengths"].data_ptr(), None,
                        0, n, bins.data_ptr(), state.data_ptr(), n, L, k,
                        sms, _kernels.stream_ptr(dev)), name)
                    return bins
                call()
                if not skip:
                    _same((call(),), (want,), "kmer %s k=%d" % (name, k))
                out.setdefault(name, {})["k%d_%dx%d" % (k, n, L)] = \
                    device_ms(call)
        del d
    return out


# the CLI commands whose walls --only cli_ops takes (chip_smoke.CLI_COMMANDS)
CLI_OP_COMMANDS = ("trim window", "trim bwa", "trim ends", "demux", "tiles")


def _cli_hashed(argv, out_dir):
    """_cli_run with out_dir made for the outputs: (the wall in seconds,
    the sha256 of its stdout, with out_dir and the directory that holds it
    masked, and of every output file, by name)."""
    import hashlib

    os.makedirs(out_dir, exist_ok=True)
    wall, text = _cli_run(argv)
    text = text.replace(out_dir, "{out}")
    h = hashlib.sha256(text.replace(os.path.dirname(out_dir),
                                    "{tmp}").encode())
    for root, _, names in sorted(os.walk(out_dir)):
        for name in sorted(names):
            with open(os.path.join(root, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return wall, h.hexdigest()


def _cli_ops(cs, seed):
    """The CLI's device ops: each call of chip_smoke.CLI_OP_TIMED on the
    first reads of chip_smoke's 1M x 150 bp file as the CLI pads them
    (4,096 x 256; demux 16,384 x 256) and on a 32,768 x 1,024 batch, card
    alone and with launches, beside its bound and (where the tree has the
    kernels) checked equal to its plain version, whose time is beside it;
    the launches of one call of each op (_cli_op_launches); and the walls
    of trim (three modes), demux and tiles on the file, twice each, with
    the sha256 of each command's stdout and output files."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        reads = os.path.join(tmp, "reads.fastq")
        cs.write_corpus(reads, cs.ALIGN_READS, seed + 17, planted=True)
        head = cs.cli_file_batch(reads, 4096)
        head_dm = cs.cli_file_batch(reads, 16384)
        out = dict(kernels={})
        for op, fn, kw in cs.CLI_OP_TIMED:
            src = head_dm if op == "demux" else head
            for d in (dict(zip(("tiles", "seq", "qual", "lengths"),
                               src[:4])),
                      cs.cli_op_tensors(cs.cli_op_card_batch(op, 32768, 1024,
                                                             seed), "cuda")):
                call, plain, b, whole = cs._timed_cli_op(op, fn, kw, d)
                n, L = (d["qual"] if "qual" in d else d["seq"]).shape
                rec = dict(_times(call), **b)
                if plain is not None:
                    cs.same_leaves((lambda r: r if isinstance(r, tuple)
                                    else (r,))((whole or call)()),
                                   (lambda r: r if isinstance(r, tuple)
                                    else (r,))(plain()),
                                   "%s %dx%d" % (fn, n, L))
                    rec["plain_device_ms"] = device_ms(plain, inner=2,
                                                       trials=3)
                if whole is not None:
                    rec["call_event_ms"] = event_ms(whole, inner=3,
                                                    trials=3)
                if op == "tiles":
                    lib, check = cs.tiles_library_call(d)
                    check(*plain()[1:])
                    rec["library_device_ms"] = device_ms(lib)
                    del lib, check
                out["kernels"]["%s_%dx%d" % (fn, n, L)] = rec
                del call, plain, whole
        out["sets"] = _cli_op_sets(cs, seed)
        out["tiles_call_split_ms"] = _tiles_split(cs, head)
        out["cli_op_launches_4096x256"] = _cli_op_launches(cs, reads)
        walls = {}
        cmds = dict(cs.CLI_COMMANDS)
        for name in CLI_OP_COMMANDS:
            runs = []
            for _ in range(2):
                d = os.path.join(tmp, "out")
                argv = [a.format(out=d, **{"in": reads})
                        for a in cmds[name]]
                runs.append(_cli_hashed(argv, d))
                shutil.rmtree(d)
            if runs[0][1] != runs[1][1]:
                raise AssertionError("cli %s: two runs differ" % name)
            walls[name] = dict(wall_s=[w for w, _ in runs],
                               sha256=runs[0][1])
        out["cli_walls"] = walls
    return out


def _ragged(cs, seed):
    import numpy as np
    import torch

    from blazeseq_tpu_torch import _kernels

    # the module (the package's `ragged_qc` attribute is the function)
    rqc = importlib.import_module("blazeseq_tpu_torch.ops.ragged_qc")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ragged.fastq")
        cs.write_ragged_corpus(path, cs.PARSE_CHUNK, seed + 23)
        c = torch.from_numpy(np.fromfile(path, np.uint8)).cuda()
    n = c.numel()
    kw = dict(width=cs.QC_WIDTH, q_lo=33, q_hi=126, offset=33,
              check_ascii=True, check_quality=True)
    _same((rqc._ragged_qc_raw_cuda(c, n, **kw),),
          (rqc._ragged_qc_raw_torch(c, n, **kw),), "ragged_qc")
    out = dict(_times(lambda: rqc._ragged_qc_raw_cuda(c, n, **kw), inner=5),
               bytes=n,
               scratch_bytes=cs.ragged_scratch_bytes(rqc._ragged_qc_raw_cuda,
                                                     c, n, **kw),
               bound_ms=cs.bound(n + 4 * sum(rqc.raw_sizes(cs.QC_WIDTH)),
                                 n)["bound_ms"])
    if hasattr(rqc, "tile_count"):
        # one pass after a zero fill: the fill on its own, and the blocks
        # of the kernel an SM holds
        out.update(fill_device_ms=device_ms(
            cs.ragged_fill(c, n, cs.QC_WIDTH), inner=5),
                   blocks_per_sm=_kernels.load().bs_ragged_qc_blocks_per_sm(
                       cs.QC_WIDTH))
    else:
        # a tree whose ragged step starts with the scan kernel
        from blazeseq_tpu_torch.ops import scan

        lane = c[:n // 128 * 128]
        out["scan_device_ms"] = device_ms(
            lambda: scan.structural_bitmaps(lane), inner=5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged-path", action="store_true",
                    help="also time run_file_device on the 1 GiB ragged "
                    "corpus")
    ap.add_argument("--sweep", action="store_true",
                    help="also time qc_stats over rows a block x cluster "
                    "size")
    ap.add_argument("--only", choices=("device_parse", "merge",
                                       "merge_kernel", "cli_ops",
                                       "kmer_k8", "stage"),
                    help="time only this section")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_one_tree(os.path.abspath(args.one), args.seed,
                                   args.ragged_path, args.sweep, args.only)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for tree in args.tree or [HERE]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, "--seed", str(args.seed)]
                             + ["--ragged-path"] * args.ragged_path
                             + ["--sweep"] * args.sweep
                             + ["--only", args.only] * bool(args.only),
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit("kernel_bench.py: tree %s failed" % tree)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["card"] = smi
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
