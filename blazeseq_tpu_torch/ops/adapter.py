"""Adapter-content scanning over padded read batches (counterpart of
blazeseq_tpu/ops/adapter.py; FastQC's adapter panel).

For a short adapter a[0..la), m[i, j] = all_k(seq[i, j+k] == a[k]) as `la`
shifted compares, case-folded with `& 0xDF`; columns shifted in past the
row are 0x00, which never matches. A match counts only when it fits in the
read: j + la <= min(len, L). FastQC's cumulative curve is the prefix sum of
the first-occurrence counts.

`adapter_content_torch` is the plain torch version; `adapter_content`
dispatches on the tensors' device: CPU tensors take the plain version, CUDA
tensors the hand-written kernel in csrc/adapter.cu, or the call raises.
`_adapter_contents` scans a batch for every adapter of a list in one
launch and can add into a running total.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from .common import check_cuda_batch


class AdapterStats(NamedTuple):
    """Additive per-batch adapter occurrence statistics (int32 tensors on
    the device, or int64 numpy arrays in a report)."""

    first_occurrence: torch.Tensor  # [L] reads whose FIRST hit starts at j
    reads_with_adapter: torch.Tensor  # [] reads with >= 1 full occurrence
    reads_scanned: torch.Tensor  # []

    def merge(self, other: "AdapterStats") -> "AdapterStats":
        return AdapterStats(*(a + b for a, b in zip(self, other)))

    def cumulative_fraction(self) -> np.ndarray:
        """FastQC curve: fraction of reads with a hit at or before column j."""
        tot = max(int(self.reads_scanned), 1)
        return np.cumsum(np.asarray(self.first_occurrence),
                         dtype=np.float64) / tot

    def to_numpy(self) -> "AdapterStats":
        return AdapterStats(*(np.asarray(torch.as_tensor(a).cpu(), np.int64)
                              for a in self))


def _adapter_matches(seq, lengths, adapter_host: bytes):
    n, L = seq.shape
    la = len(adapter_host)
    upper = seq & 0xDF
    hit = torch.ones((n, L), dtype=torch.bool, device=seq.device)
    for k, byte in enumerate(adapter_host):
        # seq column j+k against adapter byte k; past the row: 0x00
        shifted = torch.zeros_like(upper)
        if k < L:
            shifted[:, : L - k] = upper[:, k:]
        hit &= shifted == (byte & 0xDF)
    j_idx = torch.arange(L, dtype=torch.int32, device=seq.device)[None, :]
    fit = torch.clamp(lengths.to(torch.int32), max=L)[:, None]
    return hit & (j_idx + la <= fit)


def adapter_content_torch(seq, lengths, n_records=None, *,
                          adapter_host: bytes) -> AdapterStats:
    """Plain torch version of `adapter_content`."""
    n, L = seq.shape
    if n_records is None:
        n_records = n
    row_valid = torch.arange(n, device=seq.device) < int(n_records)
    hit = _adapter_matches(seq, lengths, bytes(adapter_host)) \
        & row_valid[:, None]
    # first occurrence: a hit at j with no hit strictly before j
    first = hit & (torch.cumsum(hit, 1) == 1)
    return AdapterStats(
        first_occurrence=first.sum(0, dtype=torch.int32),
        reads_with_adapter=hit.any(1).sum(dtype=torch.int32),
        reads_scanned=torch.full((), int(n_records), dtype=torch.int32,
                                 device=seq.device),
    )


@functools.cache
def _packed(adapters: tuple, device: torch.device):
    """The adapters as the kernel takes them, made once per adapter list
    and device: their bytes & 0xDF, concatenated, as u8 on `device` (at
    least one byte, so that the kernel always has a pointer), their int32
    offsets [n + 1] there, int32 [n, 2] of each one's length and first
    four folded bytes as a little-endian word, and the longest length."""
    folded = [bytes(b & 0xDF for b in a) for a in adapters]
    offsets = np.cumsum([0] + [len(a) for a in folded], dtype=np.int32)
    meta = np.array([(len(a), int.from_bytes(a[:4], "little"))
                     for a in folded], np.uint32).view(np.int32)
    return (torch.frombuffer(bytearray(b"".join(folded) or b"\0"),
                             dtype=torch.uint8).to(device),
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(meta).to(device),
            max((len(a) for a in adapters), default=0))


def _views(flat):
    """One AdapterStats an adapter, as views of flat int32[n_ad, L + 2]."""
    L = flat.shape[1] - 2
    return tuple(AdapterStats(row[:L], row[L], row[L + 1]) for row in flat)


# the last running total that passed `_total_buffer`: (out, (n_ad, L,
# device), its buffer)
_checked_total = [None, None, None]


def _total_buffer(out, n_ad: int, L: int, device):
    """The int32[n_ad, L + 2] buffer on `device` of a running total `out`,
    or ValueError unless out holds n_ad AdapterStats whose leaves are views
    of one such buffer there, as _adapter_contents returns them."""
    seen = _checked_total
    key = (n_ad, L, device)
    if out is seen[0] and seen[1] == key:
        return seen[2]
    out = tuple(out)
    if len(out) != n_ad or not all(isinstance(st, AdapterStats)
                                   for st in out):
        raise ValueError("_adapter_contents: out must hold %d AdapterStats"
                         % n_ad)
    if n_ad == 0:
        return None
    base = out[0].first_occurrence._base
    ok = (base is not None and base.dtype == torch.int32
          and tuple(base.shape) == (n_ad, L + 2) and base.is_contiguous())
    for k, st in enumerate(out):
        if not ok:
            break
        at = base.storage_offset() + k * (L + 2)
        ok = all(leaf._base is base and tuple(leaf.shape) == shape
                 and leaf.storage_offset() == at + pos
                 for leaf, shape, pos in zip(st, ((L,), (), ()),
                                             (0, L, L + 1)))
    if not ok:
        raise ValueError("_adapter_contents: out's leaves must be views of "
                         "one int32 [%d, %d] buffer, as _adapter_contents "
                         "returns them" % (n_ad, L + 2))
    if base.device != device:
        raise ValueError("_adapter_contents: out is on %s, the batch on %s"
                         % (base.device, device))
    seen[:] = [out, key, base]
    return base


# adapters one launch takes (the kernel's hit mask is 32 bits)
_MAX_ADAPTERS_A_LAUNCH = 32


def _adapter_contents(seq, lengths, n_records, adapters_host, out=None):
    """AdapterStats of one padded batch u8[n, L] for each adapter of
    `adapters_host`, as views of one int32 [n_adapters, L + 2] buffer
    (first_occurrence, reads_with_adapter, reads_scanned a row). Given
    `out`, a tuple returned by an earlier call with as many adapters on a
    batch of the same width and device, the batch is added into it in
    place and `out` is returned; another shape, or leaves that are not
    views of one such buffer, raise ValueError. CPU tensors run
    `adapter_content_torch` once per adapter; CUDA tensors run the kernel,
    one launch for up to 32 adapters (counted in
    `adapter_content.launches`), or raise."""
    adapters = tuple(bytes(a) for a in adapters_host)
    if seq.is_cuda:
        check_cuda_batch("adapter_content", [("seq", seq)],
                         [("lengths", lengths)])
    elif seq.device.type != "cpu":
        raise ValueError("adapter_content: unsupported device %s"
                         % seq.device)
    n, L = seq.shape
    base = (None if out is None
            else _total_buffer(out, len(adapters), L, seq.device))
    if not adapters:
        return ()
    n_rec = n if n_records is None else int(n_records)
    if not seq.is_cuda:
        flat = torch.stack([torch.cat([
            st.first_occurrence, st.reads_with_adapter.view(1),
            st.reads_scanned.view(1)]) for st in (
                adapter_content_torch(seq, lengths, n_records,
                                      adapter_host=a) for a in adapters)])
        if base is None:
            return _views(flat)
        base += flat
        return out
    dev = seq.device
    flat = (torch.zeros((len(adapters), L + 2), dtype=torch.int32,
                        device=dev) if base is None else base)
    ad, ad_off, meta, la_max = _packed(adapters, dev)
    lib = _kernels.load()
    step = _MAX_ADAPTERS_A_LAUNCH
    for k in range(0, len(adapters), step):
        group = adapters[k:k + step]
        start = sum(len(a) for a in adapters[:k])
        args = (seq.data_ptr(), lengths.data_ptr(), ad.data_ptr() + start,
                ad_off.data_ptr() + 4 * k, meta.data_ptr() + 8 * k,
                flat.data_ptr() + 4 * k * (L + 2), min(n, max(n_rec, 0)), L,
                len(group), sum(len(a) for a in group), la_max, n_rec,
                _kernels.stream_ptr(dev))
        with _kernels.on_device(dev):
            err = lib.bs_adapter_contents(*args)
        _kernels.check(err, "bs_adapter_contents")
        adapter_content.launches += 1
    return _views(flat) if base is None else out


def adapter_content(seq, lengths, n_records=None, *,
                    adapter_host: bytes) -> AdapterStats:
    """Scan one padded batch u8[n, L] for `adapter_host`. `n_records` (a
    host int; None means every row) separates genuine reads from padding
    rows. Returns first-occurrence counts per start column, the number of
    reads with at least one occurrence, and the number of reads scanned.
    CPU tensors run `adapter_content_torch`; CUDA tensors run the kernel
    (counted in `adapter_content.launches`) or raise."""
    if seq.is_cuda:
        return _adapter_contents(seq, lengths, n_records, (adapter_host,))[0]
    if seq.device.type != "cpu":
        raise ValueError("adapter_content: unsupported device %s"
                         % seq.device)
    return adapter_content_torch(seq, lengths, n_records,
                                 adapter_host=adapter_host)


adapter_content.launches = 0


def adapter_content_cpu(reads, adapter: bytes, max_len=None):
    """Scalar host twin: (first_occurrence list, reads_with_adapter)."""
    ad = bytes(adapter).upper()
    L = max_len if max_len is not None else max(
        (len(r) for r in reads), default=0)
    first = [0] * L
    with_hit = 0
    for r in reads:
        pos = bytes(r).upper().find(ad)
        if pos >= 0 and pos < L:
            first[pos] += 1
            with_hit += 1
    return first, with_hit
