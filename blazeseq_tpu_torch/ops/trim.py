"""Quality trimming over padded batches, lengths only (counterpart of
blazeseq_tpu/ops/trim.py).

Every downstream op masks by `lengths`, so trimming computes new lengths
(and, for clip_ends, a start) and moves no bytes:

* clip_ends: Trimmomatic LEADING/TRAILING;
* sliding_window_trim: Trimmomatic SLIDINGWINDOW:window:mean_q;
* bwa_trim: BWA -q / seqtk trimfq 3' trimming.

Each dispatches on the tensors' device: CUDA tensors run one launch of the
hand-written kernel in csrc/trim.cu (the mode a template argument; counted
in the function's `.launches`) or the call raises; CPU tensors run the
plain torch version (`clip_ends_torch`, `sliding_window_trim_torch`,
`bwa_trim_torch`, ~25 launches a call on a card). Each has a scalar host
twin (`*_cpu`). Lengths are first clipped to the padded width: positions
past it cannot be inspected.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .common import check_cuda_batch, length_mask

_BIG = 1 << 30


def _phred(qual, offset):
    """Decoded Phred in int32, 0 below the offset."""
    q = qual.to(torch.int32)
    off = int(offset)
    return torch.where(q >= off, q - off, 0)


def _lens(qual, lengths):
    return lengths.to(torch.int32).clamp(max=qual.shape[1])


def _cols(qual):
    return torch.arange(qual.shape[1], dtype=torch.int32,
                        device=qual.device)[None, :]


def _int32(who, **values):
    """The values as ints, in the order given, raising unless each fits an
    int32."""
    out = []
    for name, v in values.items():
        v = int(v)
        if not -(1 << 31) <= v < (1 << 31):
            raise ValueError("%s: %s %d is not an int32" % (who, name, v))
        out.append(v)
    return out


_MODES = {"clip_ends": 0, "sliding_window_trim": 1, "bwa_trim": 2}


def _trim_cuda(op, qual, lengths, offset, a, b=0, window=0):
    """One launch of csrc/trim.cu in `op`'s mode, counted in
    `op.launches`: (start, new_len) for clip_ends, else the new lengths."""
    who = op.__name__
    lengths = lengths.to(torch.int32)
    check_cuda_batch(who, [("qual", qual)], [("lengths", lengths)])
    n, L = qual.shape
    if L < 1:
        raise ValueError("%s: the batch has no columns" % who)
    out = torch.empty((2 if who == "clip_ends" else 1, n), dtype=torch.int32,
                      device=qual.device)
    if n:
        lib = _kernels.load()
        dev = qual.device
        with _kernels.on_device(dev):
            err = lib.bs_trim(qual.data_ptr(), lengths.data_ptr(),
                              out[0].data_ptr(), out[-1].data_ptr(), n, L,
                              _MODES[who], offset, a, b, window,
                              _kernels.stream_ptr(dev))
        _kernels.check(err, "bs_trim")
        op.launches += 1
    return (out[0], out[1]) if who == "clip_ends" else out[0]


def _on_cpu(who, qual):
    """True for a CPU tensor, False for a CUDA one; raise for another
    device."""
    if qual.is_cuda:
        return False
    if qual.device.type != "cpu":
        raise ValueError("%s: unsupported device %s" % (who, qual.device))
    return True


def clip_ends_torch(qual, lengths, offset, leading=3, trailing=3):
    """Plain torch version of `clip_ends`."""
    lens = _lens(qual, lengths)
    mask = length_mask(lens, qual.shape[1])
    q = _phred(qual, offset)
    j = _cols(qual)
    # first kept index (lens if none), last kept index + 1 (0 if none)
    start = torch.where(mask & (q >= int(leading)), j, _BIG).amin(1)
    start = torch.minimum(start, lens)
    end = torch.where(mask & (q >= int(trailing)), j + 1, 0).amax(1)
    new_len = (end - start).clamp(min=0)
    return start.to(torch.int32), new_len.to(torch.int32)


def clip_ends(qual, lengths, offset, leading=3, trailing=3):
    """Trimmomatic LEADING/TRAILING: returns (start i32[n], new_len i32[n]);
    the kept slice is [start, start + new_len) of each read. Bases with
    quality < leading are dropped from the 5' end, < trailing from the
    3' end. CPU tensors run `clip_ends_torch`; CUDA tensors run the kernel
    (counted in `clip_ends.launches`) or raise."""
    if _on_cpu("clip_ends", qual):
        return clip_ends_torch(qual, lengths, offset, leading, trailing)
    return _trim_cuda(clip_ends, qual, lengths,
                      *_int32("clip_ends", offset=offset, leading=leading,
                              trailing=trailing))


clip_ends.launches = 0


def clip_ends_cpu(qual: bytes, offset: int, leading=3, trailing=3):
    q = [max(b - offset, 0) for b in qual]
    start = 0
    while start < len(q) and q[start] < leading:
        start += 1
    end = len(q)
    while end > start and q[end - 1] < trailing:
        end -= 1
    return start, end - start


def sliding_window_trim_torch(qual, lengths, offset, mean_q=15, *,
                              window: int = 4):
    """Plain torch version of `sliding_window_trim`."""
    n, L = qual.shape
    lens = _lens(qual, lengths)
    mask = length_mask(lens, L)
    q = torch.where(mask, _phred(qual, offset), 0)
    # window j covers [j, j + window): a difference of running sums
    c = torch.cumsum(q, 1, dtype=torch.int32)
    c = torch.cat([c.new_zeros((n, 1)), c], 1)
    wsum = c[:, window:] - c[:, :-window]
    j = torch.arange(wsum.shape[1], dtype=torch.int32,
                     device=qual.device)[None, :]
    # windows fully inside the read; compared in integers: sum < mean * w
    bad = (j + window <= lens[:, None]) & (wsum < int(mean_q) * window)
    cut = torch.where(bad, j, _BIG).amin(1)
    return torch.minimum(cut, lens).to(torch.int32)


def sliding_window_trim(qual, lengths, offset, mean_q=15, *,
                        window: int = 4):
    """Trimmomatic SLIDINGWINDOW:window:mean_q: scan 5' -> 3'; at the first
    window whose mean quality drops below mean_q, cut the read at the
    window's start. Returns new lengths i32[n]. CPU tensors run
    `sliding_window_trim_torch`; CUDA tensors run the kernel (counted in
    `sliding_window_trim.launches`; window in [1, L] and mean_q * window an
    int32) or raise."""
    if _on_cpu("sliding_window_trim", qual):
        return sliding_window_trim_torch(qual, lengths, offset, mean_q,
                                         window=window)
    window = int(window)
    if not 1 <= window <= qual.shape[1]:
        raise ValueError("sliding_window_trim: window %d outside [1, %d]"
                         % (window, qual.shape[1]))
    offset, thr = _int32("sliding_window_trim", offset=offset,
                         mean_q_times_window=int(mean_q) * window)
    return _trim_cuda(sliding_window_trim, qual, lengths, offset, thr,
                      window=window)


sliding_window_trim.launches = 0


def sliding_window_trim_cpu(qual: bytes, offset: int, mean_q=15, window=4):
    q = [max(b - offset, 0) for b in qual]
    for j in range(0, len(q) - window + 1):
        if sum(q[j:j + window]) < mean_q * window:
            return j
    return len(q)


def bwa_trim_torch(qual, lengths, offset, threshold=20):
    """Plain torch version of `bwa_trim`."""
    lens = _lens(qual, lengths)
    mask = length_mask(lens, qual.shape[1])
    d = torch.where(mask, int(threshold) - _phred(qual, offset), 0)
    # s[:, k] = sum of d over [k, len)
    c = torch.cumsum(d, 1, dtype=torch.int32)
    s = torch.where(mask, c[:, -1:] - c + d, -_BIG)
    best = s.amax(1)
    # the LARGEST k reaching the max keeps the most bases
    best_k = torch.where(s == best[:, None], _cols(qual), -1).amax(1)
    return torch.where(best > 0, best_k.clamp(min=0), lens).to(torch.int32)


def bwa_trim(qual, lengths, offset, threshold=20):
    """BWA -q / seqtk trimfq 3' trimming: cut at the position maximising the
    running sum of (threshold - q) taken from the 3' end; ties keep the
    longer read. Returns new lengths i32[n]. CPU tensors run
    `bwa_trim_torch`; CUDA tensors run the kernel (counted in
    `bwa_trim.launches`) or raise."""
    if _on_cpu("bwa_trim", qual):
        return bwa_trim_torch(qual, lengths, offset, threshold)
    return _trim_cuda(bwa_trim, qual, lengths,
                      *_int32("bwa_trim", offset=offset, threshold=threshold))


bwa_trim.launches = 0


def bwa_trim_cpu(qual: bytes, offset: int, threshold=20):
    q = [max(b - offset, 0) for b in qual]
    best, best_k, s = 0, len(q), 0
    for k in range(len(q) - 1, -1, -1):
        s += threshold - q[k]
        if s > best:
            best, best_k = s, k
    return best_k if best > 0 else len(q)
