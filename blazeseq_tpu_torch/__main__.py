"""Command-line interface of the PyTorch port:
`python -m blazeseq_tpu_torch [--torch-device cuda|cpu] <command> ...`

The commands, their options, their stdout lines and their output files are
those of `python -m blazeseq_tpu`:

  count FILE [...]      records and base_pairs per FASTQ file
  stats [--adapter SEQ ...] [--duplicates] [--quartiles] [--json]
        [--device] [--schema NAME|auto] [--html OUT.html] FILE [...]
                        QC report (QCModel.run_file; --device parses on the
                        card through QCModel.run_file_device, core QC only)
  fasta-count FILE      records/bases for FASTA
  faidx FILE            build FILE.fai (samtools-compatible)
  fetch FILE NAME [START END]   random-access FASTA subsequence via .fai
  fqidx [--stride N] FILE [...]          build FILE.fqi (FASTQ record index)
  fqidx --fetch START [--count K] FILE   print records START..START+K-1
  demux --barcode NAME=SEQ [...] [--mismatches K] [--out DIR] FILE
                        split reads by 5' barcode ('N' in a barcode matches
                        any base)
  filter [--min-len N] [--max-len N] [--min-q Q] [--fraction F]
         [--seed S] [--out FILE] FILE [...]
                        length / mean-quality / random-subsample filtering
  trim [--mode window|bwa|ends] [--q N] [--window N] [--out FILE] FILE
                        quality trimming (Trimmomatic SLIDINGWINDOW / BWA -q
                        / LEADING+TRAILING); reads trimmed to zero length
                        are dropped
  merge [--min-overlap N] [--out FILE] R1 R2
  merge --interleaved [...] FILE
                        PEAR-style paired-end overlap merging
  tiles FILE [...]      FastQC per-tile sequence quality

`--torch-device` picks where stats, demux, trim, merge and tiles run:
"cuda" (the default) needs a CUDA card and raises without one; "cpu" runs
the plain torch versions of the kernels. count, fasta-count, faidx, fetch,
fqidx and filter are host-only and run the reference's commands.
"""

from __future__ import annotations

import os
import sys


def _stats(args, dev):
    from .models.qc import QCModel

    adapters = []
    duplicates = False
    quartiles = False
    as_json = False
    device_ingest = False
    html_out = None
    schema = "sanger"
    paths = []
    it = iter(args)
    for a in it:
        if a == "--html":
            try:
                html_out = next(it)
            except StopIteration:
                print("usage: stats --html OUT.html FILE", file=sys.stderr)
                raise SystemExit(2)
        elif a == "--adapter":
            try:
                adapters.append(next(it).encode("ascii"))
            except StopIteration:
                print("usage: stats --adapter SEQUENCE [...] FILE",
                      file=sys.stderr)
                raise SystemExit(2)
        elif a == "--schema":
            try:
                schema = next(it)  # a schema name, or "auto" to infer
            except StopIteration:
                print("usage: stats --schema NAME|auto FILE",
                      file=sys.stderr)
                raise SystemExit(2)
        elif a == "--duplicates":
            duplicates = True
        elif a == "--quartiles":
            quartiles = True
        elif a == "--json":
            as_json = True
        elif a == "--device":
            device_ingest = True
        else:
            paths.append(a)
    for path in paths:
        qc = QCModel(quality_schema=schema, check_ascii=True,
                     check_quality=True, adapters=adapters or None,
                     track_duplicates=duplicates,
                     track_quartiles=quartiles, device=dev)
        report = (qc.run_file_device(path) if device_ingest
                  else qc.run_file(path))
        if html_out:
            from blazeseq_tpu.report import write_html

            out = html_out if len(paths) == 1 else \
                "%s.%s.html" % (html_out.rsplit(".html", 1)[0],
                                os.path.basename(path))
            write_html(report, out, title="QC report — %s"
                       % os.path.basename(path))
            print("wrote %s" % out)
        if as_json:
            import json

            print(json.dumps(dict(file=path, **report.to_dict())))
            continue
        print("%s: %s" % (path, report))
        for ad, st in (report.adapter_stats or {}).items():
            frac = st.cumulative_fraction()[-1]
            print("  adapter %s: %.3f%% of reads"
                  % (ad.decode("ascii"), 100.0 * frac))
        if duplicates:
            print("  unique reads: %.2f%%  dup levels 1..10+: %s"
                  % (100.0 * report.frac_unique_reads,
                     report.duplication_levels[1:].tolist()))
            for s, c in report.overrepresented[:5]:
                print("  overrepresented (%d): %s"
                      % (c, s.decode("ascii", "replace")))


def _demux(args, dev):
    """demux --barcode NAME=SEQ [...] [--mismatches K] [--out DIR] FILE"""
    import blazeseq_tpu as bt
    from blazeseq_tpu.io.writers import BufferedWriter, FileWriter

    from .ops.demux import demultiplex_to_writers

    usage = ("usage: demux --barcode NAME=SEQ [...] [--mismatches K]"
             " [--out DIR] FILE")
    names = []
    codes = []
    max_mm = 1
    out_dir = "."
    paths = []
    it = iter(args)
    for a in it:
        try:
            if a == "--barcode":
                spec = next(it)
                name, _, seq = spec.partition("=")
                if not seq:
                    name, seq = "sample%d" % (len(names) + 1), name
                names.append(name)
                codes.append(seq.encode("ascii"))
            elif a == "--mismatches":
                max_mm = int(next(it))
            elif a == "--out":
                out_dir = next(it)
            else:
                paths.append(a)
        except StopIteration:
            print(usage, file=sys.stderr)
            raise SystemExit(2)
    if not codes or not paths:
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    os.makedirs(out_dir, exist_ok=True)
    for path in paths:
        writers = [BufferedWriter(FileWriter(
            os.path.join(out_dir, "%s.fastq" % n))) for n in names]
        un = BufferedWriter(FileWriter(
            os.path.join(out_dir, "unassigned.fastq")))
        parser = bt.FastqParser(bt.open_reader(path))
        totals = demultiplex_to_writers(parser, codes, writers,
                                        unassigned_writer=un,
                                        max_mismatches=max_mm, device=dev)
        for w in writers + [un]:
            w.close()
        for n, t in zip(names + ["unassigned"], totals):
            print("%s\t%s\t%d" % (path, n, t))


def _trim(args, dev):
    """trim [--mode window|bwa|ends] [--q N] [--window N] [--out FILE] FILE"""
    import numpy as np

    import blazeseq_tpu as bt
    from blazeseq_tpu.fastq.batch import serialize_fastq_rows
    from blazeseq_tpu.io.writers import BufferedWriter, FileWriter

    from .fastq.batch import padded_to_device
    from .ops import trim as trim_ops

    mode, q, window, out_path = "window", None, 4, None
    paths = []
    it = iter(args)
    for a in it:
        try:
            if a == "--mode":
                mode = next(it)
            elif a == "--q":
                q = int(next(it))
            elif a == "--window":
                window = int(next(it))
            elif a == "--out":
                out_path = next(it)
            else:
                paths.append(a)
        except StopIteration:
            paths = []
            break
    if not paths or mode not in ("window", "bwa", "ends"):
        print("usage: trim [--mode window|bwa|ends] [--q N] [--window N]"
              " [--out FILE] FILE", file=sys.stderr)
        raise SystemExit(2)
    # one writer across all inputs (FileWriter truncates on open)
    w = BufferedWriter(FileWriter(out_path)) if out_path else None
    for path in paths:
        parser = bt.FastqParser(bt.open_reader(path))
        off = parser.quality_schema.OFFSET
        total = kept = 0
        bases_in = bases_out = 0
        for batch in parser.batches(4096):
            # width sized to the batch: a fixed cap would zero the quality
            # tail of longer reads and mis-trim them
            pb = batch.to_padded()
            d = padded_to_device(pb, dev)
            qual, lens = d.qual, d.lengths
            starts = None
            if mode == "window":
                new = trim_ops.sliding_window_trim(
                    qual, lens, off, q if q is not None else 15,
                    window=window)
            elif mode == "bwa":
                new = trim_ops.bwa_trim(qual, lens, off,
                                        q if q is not None else 20)
            else:
                st, new = trim_ops.clip_ends(
                    qual, lens, off, leading=q if q is not None else 3,
                    trailing=q if q is not None else 3)
                starts = st.cpu().numpy()[: pb.n_records]
            new = new.cpu().numpy()[: pb.n_records]
            n = pb.n_records
            total += n
            bases_in += int(np.asarray(pb.lengths[:n], np.int64).sum())
            kept += int((new > 0).sum())
            bases_out += int(new[new > 0].sum())
            if w is not None:
                w.write_bytes(serialize_fastq_rows(
                    batch._id_bytes, batch._id_ends,
                    np.asarray(pb.seq)[:n], np.asarray(pb.qual)[:n],
                    new, sub_start=starts))
        print("%s\treads %d -> kept %d\tbases %d -> %d"
              % (path, total, kept, bases_in, bases_out))
    if w is not None:
        w.close()


def _merge(args, dev):
    """merge [--min-overlap N] [--out FILE] R1 R2
       merge --interleaved [--min-overlap N] [--out FILE] FILE"""
    import numpy as np

    import blazeseq_tpu as bt
    from blazeseq_tpu.fastq.batch import serialize_fastq_rows
    from blazeseq_tpu.io.writers import BufferedWriter, FileWriter

    from .fastq.batch import padded_to_device
    from .ops.merge import merge_pairs

    min_ov, out_path, inter = 10, None, False
    paths = []
    it = iter(args)
    for a in it:
        try:
            if a == "--min-overlap":
                min_ov = int(next(it))
            elif a == "--out":
                out_path = next(it)
            elif a == "--interleaved":
                inter = True
            else:
                paths.append(a)
        except StopIteration:
            paths = []
            break
    if len(paths) != (1 if inter else 2):
        print("usage: merge [--min-overlap N] [--out FILE] R1 R2\n"
              "       merge --interleaved [--min-overlap N] [--out FILE]"
              " FILE", file=sys.stderr)
        raise SystemExit(2)

    if inter:
        # one batch scan split by record parity; like the two-file path, no
        # per-pair id check (InterleavedFastqParser.pairs() does that)
        ip = bt.FastqParser(bt.open_reader(paths[0]))

        def next_batch_pair():
            b = ip.next_batch(8192)
            n = b.num_records()
            if n % 2:
                print("merge: interleaved stream ended with an unpaired "
                      "R1", file=sys.stderr)
                raise SystemExit(1)
            if n == 0:
                return bt.FastqBatch(), bt.FastqBatch()
            return b.deinterleave()
    else:
        p1 = bt.FastqParser(bt.open_reader(paths[0]))
        p2 = bt.FastqParser(bt.open_reader(paths[1]))

        def next_batch_pair():
            return p1.next_batch(4096), p2.next_batch(4096)

    def batch_max_len(b):
        b._finalize()
        e = b._ends
        return int(np.diff(e, prepend=0).max()) if len(e) else 0

    w = BufferedWriter(FileWriter(out_path)) if out_path else None
    pairs = merged = 0
    while True:
        b1, b2 = next_batch_pair()
        if b1.num_records() != b2.num_records():
            print("merge: mate files have unequal record counts",
                  file=sys.stderr)
            raise SystemExit(1)
        if b1.num_records() == 0:
            break
        # one width for both mates, sized to the longer of the two
        width = max(batch_max_len(b1), batch_max_len(b2), 1)
        pb1 = padded_to_device(b1.to_padded(max_len=width), dev)
        pb2 = padded_to_device(b2.to_padded(max_len=width), dev)
        res = merge_pairs(pb1.seq, pb1.qual, pb1.lengths, pb2.seq, pb2.qual,
                          pb2.lengths, min_overlap=min_ov)
        n = pb1.n_records
        lens = res.merged_len.cpu().numpy()[:n]
        pairs += n
        merged += int((lens > 0).sum())
        if w is not None:
            b1._finalize()
            w.write_bytes(serialize_fastq_rows(
                b1._id_bytes, b1._id_ends, res.seq.cpu().numpy()[:n],
                res.qual.cpu().numpy()[:n], lens))
    if w is not None:
        w.close()
    src = paths[0] if inter else "%s + %s" % (paths[0], paths[1])
    print("%s\tpairs %d\tmerged %d (%.1f%%)"
          % (src, pairs, merged,
             100.0 * merged / pairs if pairs else 0.0))


def _tiles(args, dev):
    import numpy as np

    import blazeseq_tpu as bt

    from .fastq.batch import padded_to_device
    from .ops.tiles import PerTileAccumulator, parse_illumina_tiles

    if not args:
        print("usage: tiles FILE [...]", file=sys.stderr)
        raise SystemExit(2)
    for path in args:
        parser = bt.FastqParser(bt.open_reader(path))
        off = parser.quality_schema.OFFSET
        acc = PerTileAccumulator()
        for batch in parser.batches(4096):
            batch._finalize()
            pb = padded_to_device(batch.to_padded(), dev)
            tiles = parse_illumina_tiles(batch._id_bytes, batch._id_ends)
            acc.add_batch(tiles, pb.qual, pb.lengths, off,
                          n_records=pb.n_records)
        ts, mean = acc.mean()
        _ts, dev_ = acc.deviation()
        if not len(ts):
            print("%s\t(no Illumina coordinate ids)" % path)
            continue
        for k, t in enumerate(ts.tolist()):
            m = mean[k]
            d = dev_[k]
            finite = np.isfinite(m)
            print("%s\ttile %d\tmeanQ %.2f\tmax|dev| %.2f"
                  % (path, t,
                     float(m[finite].mean()) if finite.any() else float("nan"),
                     float(np.nanmax(np.abs(d))) if finite.any()
                     else float("nan")))


# the device commands take the resolved torch device
_DEVICE_COMMANDS = {
    "stats": _stats,
    "demux": _demux,
    "trim": _trim,
    "merge": _merge,
    "tiles": _tiles,
}
_HOST_COMMANDS = ("count", "fasta-count", "faidx", "fetch", "fqidx",
                  "filter")


def _host_command(name):
    """The reference's own host-only command function."""
    from blazeseq_tpu import __main__ as ref

    return ref._COMMANDS[name]


def main(argv=None, device="cuda"):
    """Run one command; returns the exit code. `device` is the torch device
    of the device commands, overridden by a leading `--torch-device NAME`;
    "cuda" raises without a card, as QCModel does."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--torch-device"]:
        if len(argv) < 2:
            print("usage: --torch-device cuda|cpu COMMAND ...",
                  file=sys.stderr)
            return 2
        device, argv = argv[1], argv[2:]
    if not argv or argv[0] in ("-h", "--help") or (
            argv[0] not in _DEVICE_COMMANDS
            and argv[0] not in _HOST_COMMANDS):
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    cmd, args = argv[0], argv[1:]
    if cmd in _DEVICE_COMMANDS:
        from .ops.common import resolve_device

        _DEVICE_COMMANDS[cmd](args, resolve_device(device,
                                                   "blazeseq_tpu_torch"))
    else:
        _host_command(cmd)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
