"""Parity: the port's own copy of the host layer (blazeseq_tpu_torch's
readers, FASTQ parser, quality schemas, batches, FASTA / FAI / FQI indexes,
the native scanner, the synthetic generator and the HTML report) against
the reference's modules of the same names, on the CPU.

Every file in tests/data/fastq_parser/ goes through both parsers (through
`open_reader`, so the .gz and BGZF files take the inflate path) in three
modes: the same records, or the same error class, code and message with
its "Record number:" context. Also: padded batches leaf by leaf at two
widths, gzip and BGZF corpora, the generator byte for byte, write_html
byte for byte, and FASTA, FAI and FQI results. Also the copies added with
the rest of the reference's surface: BED, GFF3 and GTF on every file of
tests/data/bed_parser/ and tests/data/agat/ and on the inline inputs of
tests/test_bed_gff_gtf.py, the multi-core host feed against the
reference's on a multi-shard file, and the public names of both packages.
Nothing here needs a card.
"""

import gzip
import os

import numpy as np
import pytest

import blazeseq_tpu as ref
import blazeseq_tpu_torch as port
from blazeseq_tpu import report as ref_report
from blazeseq_tpu.fai import parser as ref_fai
from blazeseq_tpu.fasta import parser as ref_fasta
from blazeseq_tpu.fastq import index as ref_index
from blazeseq_tpu.fastq import paired as ref_paired
from blazeseq_tpu.fastq import quality as ref_quality
from blazeseq_tpu_torch import report as port_report
from blazeseq_tpu_torch.fai import parser as port_fai
from blazeseq_tpu_torch.fasta import parser as port_fasta
from blazeseq_tpu_torch.fastq import index as port_index
from blazeseq_tpu_torch.fastq import paired as port_paired
from blazeseq_tpu_torch.fastq import quality as port_quality

DATA = os.path.join(os.path.dirname(__file__), "data")
FASTQ_DIR = os.path.join(DATA, "fastq_parser")
FASTA_DIR = os.path.join(DATA, "fasta_parser")
FASTQ_FILES = sorted(os.listdir(FASTQ_DIR))
FASTA_FILES = sorted(f for f in os.listdir(FASTA_DIR) if f != "README.md")
BED_DIR = os.path.join(DATA, "bed_parser")
AGAT_DIR = os.path.join(DATA, "agat")
FEATURE_FILES = sorted(
    ["bed_parser/" + f for f in os.listdir(BED_DIR) if f.endswith(".bed")]
    + ["agat/" + os.path.relpath(os.path.join(d, f), AGAT_DIR)
       for d, _, fs in os.walk(AGAT_DIR) for f in fs
       if f.endswith((".gff", ".gtf"))])


def _schema_of(name):
    """The quality schema a corpus file is written in, from its name."""
    for key, schema in (("_as_sanger", "sanger"), ("_as_solexa", "solexa"),
                        ("_as_illumina", "illumina_1.3"),
                        ("solexa", "solexa"), ("illumina", "illumina_1.3"),
                        ("sanger", "sanger")):
        if key in name:
            return schema
    return "generic"


def _outcome(pkg, path, mode):
    """What one package's validating parser makes of a file: ("ok", the
    records or counts) or ("error", class name, code, message)."""
    cfg = pkg.ParserConfig(check_ascii=True, check_quality=True,
                           quality_schema=_schema_of(os.path.basename(path)))
    p = pkg.FastqParser(pkg.open_reader(path), config=cfg)
    try:
        if mode == "records":
            got = [(r.id_bytes(), r.sequence_bytes(), r.quality_bytes())
                   for r in p.records()]
        elif mode == "views":
            got = [(bytes(v.id_bytes()), bytes(v.sequence_bytes()),
                    bytes(v.quality_bytes())) for v in p.views()]
        elif mode == "batches":
            got = []
            for b in p.batches(7):
                got += [(r.id_bytes(), r.sequence_bytes(), r.quality_bytes())
                        for r in (b.get_record(i) for i in range(len(b)))]
        else:
            got = p.count()
        return ("ok", got)
    except Exception as e:  # compared field by field below
        code = getattr(e, "code", None)
        return ("error", type(e).__name__,
                None if code is None else int(code), str(e))


@pytest.mark.parametrize("mode", ["records", "views", "batches", "count"])
@pytest.mark.parametrize("fname", FASTQ_FILES)
def test_parser_matches_reference_on_corpus(fname, mode):
    path = os.path.join(FASTQ_DIR, fname)
    want = _outcome(ref, path, mode)
    got = _outcome(port, path, mode)
    assert got == want
    if got[0] == "error" and got[2] is not None and got[2] != 6:
        # a parse or validation error names the record it stopped at
        assert "Record number:" in got[3]


def test_error_classes_are_the_ports_own():
    """The port raises its own error classes, which mirror the reference's
    names and codes."""
    from blazeseq_tpu import errors as ref_errors
    from blazeseq_tpu_torch import errors as port_errors

    for name in ("FastxError", "FastxEOFError", "ParseError",
                 "ValidationError"):
        assert getattr(port_errors, name) is not getattr(ref_errors, name)
    assert ({c.name: int(c) for c in port_errors.FastxErrorCode}
            == {c.name: int(c) for c in ref_errors.FastxErrorCode})
    p = port.FastqParser(port.MemoryReader(b"@r\nACGT\n+\nII\n"))
    with pytest.raises(port_errors.ParseError, match="Record number: 1"):
        list(p.records())


def _corpus(n, lo, hi, seed):
    return bytes(ref.generate_variable_id_fastq_buffer(
        n, lo, hi, 2, 40, "sanger", seed=seed))


@pytest.mark.parametrize("width", [128, 256])
def test_padded_batches_match_leaf_by_leaf(width):
    buf = _corpus(700, 20, 300, seed=width)
    kw = dict(max_len=width, pad_records_to=256)
    want = list(ref.FastqParser(ref.MemoryReader(buf)).padded_batches(
        200, **kw))
    got = list(port.FastqParser(port.MemoryReader(buf)).padded_batches(
        200, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.n_records == w.n_records
        assert g.quality_offset == w.quality_offset
        n = w.n_records
        for leaf in ("seq", "qual", "lengths"):
            a, b = getattr(g, leaf), getattr(w, leaf)
            assert a.dtype == b.dtype and a.shape == b.shape, leaf
            # rows past n_records are scratch in both packages
            assert np.array_equal(a[:n], b[:n]), leaf
        assert not np.asarray(g.lengths)[n:].any()


def test_batches_and_serializers_match():
    from blazeseq_tpu.fastq import batch as ref_batch
    from blazeseq_tpu_torch.fastq import batch as port_batch

    buf = _corpus(300, 1, 180, seed=5)
    bw = ref.FastqParser(ref.MemoryReader(buf)).next_batch(300)
    bg = port.FastqParser(port.MemoryReader(buf)).next_batch(300)
    assert type(bg) is port_batch.FastqBatch
    for a, b in ((bg.to_padded(), bw.to_padded()),
                 (bg.to_padded(max_len=64), bw.to_padded(max_len=64))):
        assert np.array_equal(a.seq, b.seq) and np.array_equal(a.qual, b.qual)
        assert np.array_equal(a.lengths, b.lengths)
    pw = bw.to_padded()
    bw._finalize()
    starts = np.arange(len(bw), dtype=np.int64) % 5
    for sub in (None, starts):
        rows = (bw._id_bytes, bw._id_ends, pw.seq, pw.qual,
                np.maximum(pw.lengths - 5, 0).astype(np.int32))
        assert (port_batch.serialize_fastq_rows(*rows, sub_start=sub)
                == ref_batch.serialize_fastq_rows(*rows, sub_start=sub))
    keep = np.arange(len(bw)) % 3 != 0
    lens = np.diff(np.concatenate(([0], bw._ends)))
    soa = (bw._id_bytes, bw._id_ends, bw._sequence_bytes, bw._quality_bytes,
           bw._ends)
    kw = dict(sub_start=np.zeros(len(lens), np.int64),
              sub_len=np.where(keep, lens, 0))
    assert (port_batch.serialize_fastq_soa(*soa, **kw)
            == ref_batch.serialize_fastq_soa(*soa, **kw))


@pytest.mark.parametrize("kind", ["gzip", "bgzf"])
def test_compressed_input_through_open_reader(kind, tmp_path):
    buf = _corpus(3000, 30, 160, seed=11)
    if kind == "gzip":
        path = tmp_path / "r.fastq.gz"
        path.write_bytes(gzip.compress(buf))
    else:
        # BGZF: gzip members of <= 64 KiB input, each with the BC extra field
        import struct
        import zlib

        parts = []
        for i in range(0, len(buf), 60000):
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            body = co.compress(buf[i:i + 60000]) + co.flush()
            blk = (b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0"
                   + struct.pack("<H", len(body) + 25) + body
                   + struct.pack("<II", zlib.crc32(buf[i:i + 60000]),
                                 len(buf[i:i + 60000])))
            parts.append(blk)
        parts.append(b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0\x1b\0"
                     b"\x03\0\0\0\0\0\0\0\0\0")
        path = tmp_path / "r.fastq.bgz"
        path.write_bytes(b"".join(parts))
    rd, rp = ref.open_reader(str(path)), port.open_reader(str(path))
    assert type(rp).__name__ == type(rd).__name__
    assert type(rp).__module__.startswith("blazeseq_tpu_torch.")
    want = [(r.id_bytes(), r.sequence_bytes(), r.quality_bytes())
            for r in ref.FastqParser(rd).records()]
    got = [(r.id_bytes(), r.sequence_bytes(), r.quality_bytes())
           for r in port.FastqParser(rp).records()]
    assert got == want and len(got) == 3000
    assert (port.parser(str(path)).count()
            == ref.parser(str(path)).count())


@pytest.mark.parametrize("schema", ["sanger", "illumina_1.3", "solexa"])
def test_generator_is_byte_equal(schema):
    args = (500, 10, 200, 2, 40, schema)
    assert (port.generate_synthetic_fastq_buffer(*args, gc_bias=0.3)
            == ref.generate_synthetic_fastq_buffer(*args, gc_bias=0.3))


@pytest.mark.parametrize("name", ["generic", "sanger", "solexa",
                                  "illumina_1.3", "illumina_1.5",
                                  "illumina_1.8"])
def test_quality_schemas_match(name):
    a, b = port.parse_schema(name), ref.parse_schema(name)
    assert (a.LOWER, a.UPPER, a.OFFSET) == (b.LOWER, b.UPPER, b.OFFSET)
    assert port_quality.schema_key(a) == ref_quality.schema_key(b)


@pytest.mark.parametrize("fname", ["illumina_full_range_as_illumina.fastq",
                                   "solexa_example.fastq",
                                   "sanger_full_range_as_sanger.fastq",
                                   "example.fastq"])
def test_quality_detection_matches(fname):
    path = os.path.join(FASTQ_DIR, fname)
    a = port_quality.detect_quality_schema_file(path)
    b = ref_quality.detect_quality_schema_file(path)
    assert port_quality.schema_key(a) == ref_quality.schema_key(b)


@pytest.fixture(scope="module")
def qc_reports(tmp_path_factory):
    """QC reports of the port on a small corpus, without and with the
    optional panels."""
    p = tmp_path_factory.mktemp("html") / "r.fastq"
    p.write_bytes(_corpus(1500, 40, 150, seed=2))
    plain = port.QCModel(quality_schema="sanger", device="cpu").run_file(
        str(p))
    panels = port.QCModel(quality_schema="sanger", adapters=[b"ACGTAC"],
                          track_duplicates=True, track_quartiles=True,
                          device="cpu").run_file(str(p))
    return dict(plain=plain, panels=panels)


@pytest.mark.parametrize("which", ["plain", "panels"])
def test_write_html_is_byte_equal(which, qc_reports, tmp_path):
    rep = qc_reports[which]
    port_report.write_html(rep, str(tmp_path / "port.html"), title="t")
    ref_report.write_html(rep, str(tmp_path / "ref.html"), title="t")
    got = (tmp_path / "port.html").read_bytes()
    assert got == (tmp_path / "ref.html").read_bytes()
    assert got.startswith(b"<!doctype html>")


@pytest.mark.parametrize("fname", FASTA_FILES)
def test_fasta_and_fai_match(fname):
    path = os.path.join(FASTA_DIR, fname)

    def outcome(mod, pkg):
        try:
            recs = [(r.id_bytes(), r.sequence_bytes())
                    for r in mod.FastaParser(pkg.open_reader(path)).records()]
            counts = mod.FastaParser(pkg.open_reader(path)).count()
        except Exception as e:  # compared as class name and message
            return ("error", type(e).__name__, str(e))
        return ("ok", recs, counts)

    def fai(mod, pkg):
        try:
            return [vars(r) for r in mod.build_fai(pkg.io.readers.FileReader(
                path))]
        except Exception as e:  # compared as class name and message
            return ("error", type(e).__name__, str(e))

    assert outcome(port_fasta, port) == outcome(ref_fasta, ref)
    assert fai(port_fai, port) == fai(ref_fai, ref)


def test_indexed_fasta_fetch_matches(tmp_path):
    rng = np.random.default_rng(1)
    recs = []
    for i in range(6):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                         int(rng.integers(1, 400))).tobytes()
        lines = [seq[j:j + 60] for j in range(0, len(seq), 60)]
        recs.append(b">chr%d desc\n" % i + b"\n".join(lines) + b"\n")
    path = tmp_path / "g.fa"
    path.write_bytes(b"".join(recs))
    with port_fai.IndexedFasta(str(path)) as a, \
            ref_fai.IndexedFasta(str(path)) as b:
        assert a.names() == b.names()
        for name in b.names():
            n = b.length(name)
            assert a.length(name) == n
            for start, end in ((0, None), (0, n), (n // 3, n // 2 + 1),
                               (n - 1, n)):
                assert a.fetch(name, start, end) == b.fetch(name, start, end)


@pytest.mark.parametrize("stride", [1, 37, 10_000])
def test_fqidx_matches(stride, tmp_path):
    buf = _corpus(800, 20, 120, seed=stride)
    path = tmp_path / "r.fastq"
    path.write_bytes(buf)
    a = port_index.build_fqi(str(path), stride=stride)
    b = ref_index.build_fqi(str(path), stride=stride)
    assert (a.stride, a.n_records, a.n_bases, a.n_bytes, a.bgzf) == (
        b.stride, b.n_records, b.n_bases, b.n_bytes, b.bgzf)
    assert np.array_equal(a.offsets, b.offsets)
    port_index.write_fqi(a, str(tmp_path / "a.fqi"))
    ref_index.write_fqi(b, str(tmp_path / "b.fqi"))
    assert (tmp_path / "a.fqi").read_bytes() == (tmp_path / "b.fqi") \
        .read_bytes()
    with port_index.IndexedFastq(str(path), stride=stride) as x, \
            ref_index.IndexedFastq(str(path), stride=stride) as y:
        for start, k in ((0, 3), (399, 5), (799, 1)):
            assert ([r.to_bytes() for r in x.fetch(start, k)]
                    == [r.to_bytes() for r in y.fetch(start, k)])
        assert x.shard_ranges(3) == y.shard_ranges(3)


def test_paired_parsers_match():
    r1 = b"".join(b"@p%d/1\nACGT\n+\nIIII\n" % i for i in range(40))
    r2 = b"".join(b"@p%d/2\nTTGGA\n+\nJJJJJ\n" % i for i in range(40))
    a = [(x.to_bytes(), y.to_bytes()) for x, y in port_paired.PairedFastqParser(
        port.MemoryReader(r1), port.MemoryReader(r2)).pairs()]
    b = [(x.to_bytes(), y.to_bytes()) for x, y in ref_paired.PairedFastqParser(
        ref.MemoryReader(r1), ref.MemoryReader(r2)).pairs()]
    assert a == b and len(a) == 40
    bad = r2.replace(b"@p7/2", b"@zz/2")
    with pytest.raises(port_paired.PairSyncError) as ei:
        list(port_paired.PairedFastqParser(port.MemoryReader(r1),
                                           port.MemoryReader(bad)).pairs())
    with pytest.raises(ref_paired.PairSyncError) as ej:
        list(ref_paired.PairedFastqParser(ref.MemoryReader(r1),
                                          ref.MemoryReader(bad)).pairs())
    assert str(ei.value) == str(ej.value)


def test_native_scanner_is_the_ports_own_build():
    """The port builds and loads its own native libraries; scans agree."""
    from blazeseq_tpu import native as ref_native
    from blazeseq_tpu_torch import native as port_native

    assert port_native is not ref_native
    assert port_native.has_native() == ref_native.has_native()
    window = np.frombuffer(_corpus(400, 1, 90, seed=3), np.uint8).copy()
    a = port_native.count_fastq(window, 0, True)
    b = ref_native.count_fastq(window, 0, True)
    assert a == b
    assert np.array_equal(port_native.find_newlines(window),
                          ref_native.find_newlines(window))


SHARD_FILES = [f for f in FASTQ_FILES
               if not f.endswith((".gz", ".bgz", ".fqi"))]


@pytest.mark.parametrize("fname", SHARD_FILES)
def test_record_boundaries_match(fname):
    """The port's copy of parallel/sharding.py finds the reference's record
    boundary at every offset of a parser corpus file, with the default and
    a short probe window."""
    from blazeseq_tpu.parallel import sharding as ref_sharding
    from blazeseq_tpu_torch.parallel import sharding as port_sharding

    path = os.path.join(FASTQ_DIR, fname)
    data = np.fromfile(path, np.uint8)
    step = max(1, len(data) // 300)
    for off in list(range(-1, len(data) + 2, step)) + [len(data) - 1]:
        for probe in (1 << 20, 64):
            assert (port_sharding.find_record_boundary_bytes(data, off, probe)
                    == ref_sharding.find_record_boundary_bytes(data, off,
                                                               probe)), off
        assert (port_sharding.find_record_boundary(path, off)
                == ref_sharding.find_record_boundary(path, off))


@pytest.mark.parametrize("with_fqi", [False, True])
def test_shard_file_matches(with_fqi, tmp_path):
    from blazeseq_tpu.parallel import sharding as ref_sharding
    from blazeseq_tpu_torch.parallel import sharding as port_sharding

    path = tmp_path / "r.fastq"
    path.write_bytes(_corpus(900, 20, 140, seed=4))
    if with_fqi:
        port_index.write_fqi(port_index.build_fqi(str(path), stride=7),
                             str(path) + ".fqi")
    for n in (1, 2, 3, 7, 64):
        got = port_sharding.shard_file(str(path), n)
        assert got == ref_sharding.shard_file(str(path), n)
        start, end = got[n // 2]
        reader = port_sharding.open_shard(str(path), n, n // 2)
        buf = bytearray(end - start + 1)
        k = reader.readinto(memoryview(buf))
        reader.close()
        assert bytes(buf[:k]) == path.read_bytes()[start:end]


def _semi_corpus(n, L, seed):
    return bytes(ref.generate_variable_id_fastq_buffer(
        n, L, L, 2, 40, "sanger", seed=seed))


@pytest.mark.parametrize("case", ["var_ids", "length_change", "wide_id",
                                  "partial_tail", "small_out"])
@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_normalize_semi_uniform_matches(case, impl):
    """The port's id normalizer (its native build and its numpy twin)
    against the reference's, on the corpora of
    tests/test_normalize_semi_uniform.py."""
    from blazeseq_tpu import native as ref_native
    from blazeseq_tpu_torch import native as port_native

    v = _semi_corpus(500, 100, 1)
    idw, L, cap = 64, 100, 600
    if case == "length_change":
        v = _semi_corpus(50, 100, 1) + _semi_corpus(50, 60, 2)
    elif case == "wide_id":
        big = b"@" + b"X" * 120 + b"\n" + b"A" * 100 + b"\n+\nI" + b"I" * 99
        v = v[:v.index(b"\n@", len(v) // 2) + 1] + big + b"\n" + v
    elif case == "partial_tail":
        v = v[:len(v) - 30]
    elif case == "small_out":
        cap = 17
    buf = np.frombuffer(v, np.uint8)
    rs = idw + 2 * L + 6
    outs = []
    for mod in (port_native, ref_native):
        fn = (mod.normalize_semi_uniform if impl == "native"
              else mod._normalize_semi_uniform_np)
        out = np.zeros(cap * rs, np.uint8)
        res = [fn(buf, 0, out, idw, L)]
        if res[0][0]:  # and from where the first call stopped
            res.append(fn(buf, res[0][1], out[res[0][0] * rs:], idw, L))
        outs.append((res, out.tobytes()))
    assert outs[0] == outs[1]
    assert outs[0][0][0][0] > 0


def test_peek_semi_uniform_matches():
    from blazeseq_tpu.models.qc import QCModel as RefQCModel
    from blazeseq_tpu_torch.models.qc import QCModel as PortQCModel

    heads = [_semi_corpus(100, 100, 1), _semi_corpus(50, 60, 2),
             bytes(ref.generate_synthetic_fastq_buffer(50, 80, 80, 2, 40,
                                                       "sanger")),
             _corpus(50, 60, 110, seed=3), b"@r\nAC\n+x\nII\n", b"@r\n\n+\n\n",
             b"@r\nACGT\n+\nIIII", b""]
    for h in heads:
        a = np.frombuffer(h, np.uint8)
        for kw in ({}, dict(head_bytes=300, margin=0)):
            assert (PortQCModel._peek_semi_uniform(a, **kw)
                    == RefQCModel._peek_semi_uniform(a, **kw)), (h[:40], kw)


# ------------------------------------------------------------ BED, GFF3, GTF

def _feature_outcome(pkg, reader, kind, strict=False):
    """What one package's BED / GFF3 / GTF parser makes of a source: ("ok",
    each record's line and length, and the GFF3 sequence regions) or
    ("error", class name, message, the records before it)."""
    if kind == "bed":
        parser = pkg.BedParser(reader)
    elif kind == "gff":
        parser = pkg.Gff3Parser(reader)
    else:
        parser = pkg.GtfParser(reader, strict_mandatory_attrs=strict)
    got = []
    try:
        for rec in parser.records():
            got.append((rec.to_bytes(), len(rec)))
    except Exception as e:  # compared by class name and message
        return ("error", type(e).__name__, str(e), got)
    regions = ([(r.seqid, str(r.region))
                for r in parser.sequence_regions()]
               if kind == "gff" else None)
    return ("ok", got, regions)


@pytest.mark.parametrize("rel", FEATURE_FILES)
def test_feature_file_matches_reference(rel):
    """Every BED fixture and AGAT GFF3 / GTF file through both packages'
    parsers (GTF without mandatory attributes, as tests/test_bed_gff_gtf.py
    sweeps it): the same records or the same error."""
    path = os.path.join(DATA, rel)
    kind = os.path.splitext(rel)[1][1:]
    want = _feature_outcome(ref, ref.FileReader(path), kind)
    got = _feature_outcome(port, port.FileReader(path), kind)
    assert got == want
    assert got[0] == "error" or got[1]


_GFF_BASIC = (b"##gff-version 3\n##sequence-region ctg123 1 1497228\n"
              b"ctg123\t.\tgene\t1000\t9000\t.\t+\t.\tID=gene00001;"
              b"Name=EDEN\nctg123\t.\tmRNA\t1050\t9000\t6.2\t+\t.\t"
              b"ID=mRNA1;Parent=gene00001\nctg123\t.\tCDS\t1201\t1500\t.\t"
              b"+\t0\tID=cds1;Parent=mRNA1\n")
_GTF_LINE = (b'chr1\thavana\tgene\t11869\t14409\t.\t+\t.\t'
             b'gene_id "ENSG0001"; transcript_id "ENST0001"; '
             b'gene_name "DDX11L1"; exon_number 3;\n')
# the inline inputs of tests/test_bed_gff_gtf.py: (parser, bytes, strict)
FEATURE_INPUTS = [
    ("bed", b"# comment\ntrack name=x\nbrowser position chr1\n"
     b"chr1\t10\t20\n\nchr2\t5\t9\n", False),
    ("bed", b"chr1\t10\n", False),
    ("bed", b"chr1\t30\t20\n", False),
    ("bed", b"chr1\t1x\t20\n", False),
    ("bed", b"chr1\t1\t2\tn\t2000\n", False),
    ("bed", b"chr1\t1\t2\tn\t0\tx\n", False),
    ("bed", b"chr1\t1\t2\tn\t0\t+\t1\t2\t1,2\n", False),
    ("bed", b"chr1\t1\t2\tn\t0\t+\t1\t2\t300,0,0\n", False),
    ("bed", b"chr1\t1\t2\tn\t0\t+\t1\t2\t0\textraA\n", False),
    ("gff", _GFF_BASIC, False),
    ("gff", _GFF_BASIC + b"##FASTA\n>ctg123\nACGT\n", False),
    ("gff", b"##gff-version 2\nctg\t.\tg\t1\t2\t.\t+\t.\tID=1\n", False),
    ("gff", b"##gff-version 3.1.26\nctg\t.\tg\t1\t2\t.\t+\t.\tID=1\n",
     False),
    ("gff", b"a\tb\tc\n", False),
    ("gff", b"a\tb\tg\t0\t5\t.\t+\t.\t.\n", False),
    ("gff", b"a\tb\tg\t9\t5\t.\t+\t.\t.\n", False),
    ("gff", b"a\tb\tg\t1\t5\t.\tx\t.\t.\n", False),
    ("gff", b"a\tb\tg\t1\t5\t.\t+\t7\t.\n", False),
    ("gff", b"a\tb\tCDS\t1\t5\t.\t+\t.\t.\n", False),
    ("gtf", _GTF_LINE, True),
    ("gtf", b"#!genome-build x\n" + _GTF_LINE, True),
    ("gtf", b'chr1\ts\tgene\t1\t5\t.\t+\t.\tgene_name "x";\n', True),
    ("gtf", b'chr1\ts\tgene\t1\t5\t.\t+\t.\tgene_name "x";\n', False),
]


@pytest.mark.parametrize("case", range(len(FEATURE_INPUTS)))
def test_feature_input_matches_reference(case):
    kind, data, strict = FEATURE_INPUTS[case]
    want = _feature_outcome(ref, ref.MemoryReader(data), kind, strict)
    got = _feature_outcome(port, port.MemoryReader(data), kind, strict)
    assert got == want


def test_feature_attributes_and_writer_match():
    """Attribute parsers on the reference test's values, and BED records
    written back by BedWriter, byte for byte."""
    from blazeseq_tpu.gff import parse_target_attribute as ref_target
    from blazeseq_tpu_torch.gff import parse_target_attribute as port_target

    gff = b"ID=x%3By;Dbxref=DB:1,DB:2;Note=a%2Cb"
    assert (port.parse_gff3_attributes(gff).items()
            == ref.parse_gff3_attributes(gff).items())
    gtf = b'gene_id "g;1"; transcript_id "t\\"x"; note "a\\\\b";'
    a, b = port.parse_gtf_attributes(gtf), ref.parse_gtf_attributes(gtf)
    assert (a.gene_id, a.transcript_id, a.get("note")) == (
        b.gene_id, b.transcript_id, b.get("note"))
    for t in (b"EST23 1 21 +", b"EST9 5 10"):
        x, y = port_target(t), ref_target(t)
        assert (x.target_id, x.start, x.end, str(x.strand)) == (
            y.target_id, y.start, y.end, str(y.strand))
    for n in (3, 6, 12):
        path = os.path.join(BED_DIR, "bed%d.bed" % n)
        outs = []
        for pkg in (port, ref):
            w = pkg.buffered_writer_for_memory()
            bw = pkg.BedWriter(w)
            for r in pkg.BedParser(pkg.FileReader(path)).records():
                bw.write_record(r)
            w.flush()
            outs.append(w._backend.getvalue())
        assert outs[0] == outs[1] and outs[0]


# ------------------------------------------------------ multi-core host feed

@pytest.fixture(scope="module")
def feed_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("feed") / "corpus.fastq"
    p.write_bytes(bytes(ref.generate_synthetic_fastq_buffer(
        5000, 40, 160, 2, 40, "sanger")))
    return str(p)


def _feed_rows(pkg, path, workers):
    """(shard id, seq, qual) of every record parallel_padded_batches
    yields, sorted (shards finish in any order)."""
    from importlib import import_module

    feed = import_module(pkg.__name__ + ".parallel.feed")
    rows = []
    for sid, pb in feed.parallel_padded_batches(path, workers=workers,
                                                max_records=257,
                                                max_len=192):
        for i in range(pb.n_records):
            L = min(int(pb.lengths[i]), 192)
            rows.append((sid, pb.seq[i, :L].tobytes(),
                         pb.qual[i, :L].tobytes(), int(pb.lengths[i])))
    return sorted(rows)


@pytest.mark.parametrize("workers", [1, 3, 7])
def test_parallel_feed_matches_reference(feed_file, workers):
    from blazeseq_tpu.parallel import feed as ref_feed
    from blazeseq_tpu_torch.parallel import feed as port_feed

    assert (port_feed.parallel_count(feed_file, workers=workers)
            == ref_feed.parallel_count(feed_file, workers=workers))
    got = _feed_rows(port, feed_file, workers)
    assert got == _feed_rows(ref, feed_file, workers)
    assert len(got) == 5000


def test_parallel_feed_error_matches_reference(tmp_path):
    from blazeseq_tpu.parallel import feed as ref_feed
    from blazeseq_tpu_torch.parallel import feed as port_feed

    lines = bytes(ref.generate_synthetic_fastq_buffer(
        1000, 50, 50, 2, 40, "sanger")).split(b"\n")
    lines[900 * 4 + 2] = b"*"  # a bad separator in a later shard
    path = tmp_path / "bad.fastq"
    path.write_bytes(b"\n".join(lines))

    def outcome(fn):
        try:
            fn()
        except Exception as e:  # compared by class name and message
            return type(e).__name__, str(e)
        return None

    got, want = ((outcome(lambda: list(feed.parallel_padded_batches(
                      str(path), workers=3))),
                  outcome(lambda: feed.parallel_count(str(path), workers=3)))
                 for feed in (port_feed, ref_feed))
    assert got == want
    assert None not in got


# ------------------------------------------------------------- public names

# The reference's mesh names, ported on torch.distributed
MESH_NAMES = {"DP_AXIS", "make_mesh", "batch_sharding", "replicated",
              "shard_batch", "init_distributed", "run_multihost_qc",
              "build_uniform_qc_step", "build_ragged_qc_step"}


def _public_names(module):
    """The names a package's __init__ imports or defines."""
    import ast

    tree = ast.parse(open(module.__file__).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.FunctionDef) and \
                not node.name.startswith("_"):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names - {"annotations"}


@pytest.mark.parametrize("namespace", ["", ".parallel"])
def test_public_names_resolve_in_port(namespace):
    """Every public name of blazeseq_tpu and blazeseq_tpu.parallel resolves
    in the port, to an object of the port's own, the mesh names too."""
    from importlib import import_module

    ref_mod = import_module("blazeseq_tpu" + namespace)
    port_mod = import_module("blazeseq_tpu_torch" + namespace)
    names = _public_names(ref_mod)
    assert len(names) > (80 if not namespace else 8)
    missing = sorted(n for n in names if not hasattr(port_mod, n))
    assert not missing, missing
    for n in names:
        obj = getattr(port_mod, n)
        mod = getattr(obj, "__module__", None)
        assert mod is None or not mod.startswith("blazeseq_tpu."), (n, mod)
    assert (MESH_NAMES <= names) == bool(namespace)
    if not namespace:
        assert port.__version__ == ref.__version__


def _gather_case():
    """A window of two ordinary records, then a last record whose quality
    line stops 3 bytes short of its sequence with no final newline, then
    bytes that are not the record's; and the offsets the parser gives them
    (rec[4] of the last one is the end of the input)."""
    recs = [b"@r1\nACGTACGTAC\n+\nIIIIIIIIII\n", b"@r2\nACG\n+\n#5I\n",
            b"@r3\nACGTTGCA\n+\nABCDE"]
    offsets, pos = [], 0
    for r in recs:
        nl = [i for i, c in enumerate(r) if c == 10]
        end = nl[3] if len(nl) > 3 else len(r)
        offsets.append([pos, pos + nl[0] + 1, pos + nl[1] + 1,
                        pos + nl[2] + 1, pos + end])
        pos += len(r)
    window = np.frombuffer(b"".join(recs) + b"JJJJJJJJ", np.uint8).copy()
    return window, np.array(offsets, np.int64)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_gather_padded_stops_quality_at_record_end(impl, monkeypatch):
    """native.gather_padded copies a record's quality only up to its end
    (rec[4]) and zeroes the rest of the row, on the C++ gather and the
    numpy fallback; ordinary records gather byte for byte as the
    reference's gather does."""
    from blazeseq_tpu import native as ref_native
    from blazeseq_tpu_torch import native as port_native

    if impl == "numpy":
        monkeypatch.setattr(port_native, "_load", lambda: None)
    elif port_native._load() is None:
        pytest.skip("no C++ compiler: the native gather is not built")
    window, offsets = _gather_case()
    seq, qual, lengths = port_native.gather_padded(window, offsets, 12,
                                                   pad_records_to=4)
    assert lengths.tolist() == [10, 3, 8, 0]
    assert qual[2].tobytes() == b"ABCDE" + bytes(7)  # not b"ABCDEJJJ"
    assert seq[2].tobytes() == b"ACGTTGCA" + bytes(4)
    # the ordinary records (and a width that clamps them) as before
    for width in (12, 6):
        want = ref_native.gather_padded(window, offsets[:2], width)
        got = port_native.gather_padded(window, offsets[:2], width)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # `out=` buffers holding stale bytes are zeroed past the tail too
    out = tuple(np.full_like(a, 0x7F) for a in (seq, qual))
    out += (np.zeros_like(lengths),)
    port_native.gather_padded(window, offsets, 12, out=out)
    assert out[1][2].tobytes() == b"ABCDE" + bytes(7)


def test_cut_quality_tail_pads_with_zeros_in_the_parser():
    """The parser's padded batch of a file whose last quality line was cut
    (111 of 150 bytes, no final newline): the tail row holds its 111
    quality bytes, then zeros."""
    buf = bytes(port.generate_synthetic_fastq_buffer(
        12000, 150, 150, 2, 40, "sanger"))[:-40]
    last = None
    for pb in port.FastqParser(port.MemoryReader(buf)).padded_batches(
            4096, max_len=256):
        last = pb
    row = np.asarray(last.qual)[last.n_records - 1]
    tail = buf[buf.rindex(b"\n") + 1:]
    assert len(tail) == 111
    assert row[:111].tobytes() == tail and not row[111:].any()
