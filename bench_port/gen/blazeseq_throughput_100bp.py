"""The corpus of upstream BlazeSeq's throughput and parser benchmarks, made
on the device.

A frozen copy of upstream's `generate_synthetic_fastq_buffer` scheme
(utils.mojo:831-917; the port's utils.py copies it bit for bit): records
`@read_<i>` with the index zero-padded to the digits of the last one; bases
from a 64-bit MMIX LCG seeded per read, its state masked to 63 bits a step,
slot (state >> 33) % 8 of an 8-slot table with round(8 * gc_bias) G/C
slots; Phred from a linear decay ("ski slope") over the read plus LCG
jitter, clipped to [min_phred, max_phred]. The seed moves every read's LCG
key by one 64-bit offset (none for seed 0, which gives upstream's bytes),
so each seed gives other bytes of the same shape.
"""

from __future__ import annotations

import torch

from ._common import const, digits, mix_int, s64, srl, write_blocks

_A = 6364136223846793005
_C = 1442695040888963407
_QA = 1664525
_QC = 1013904223
_QMUL = 2654435761
_MASK63 = (1 << 63) - 1
_BLOCK = 1 << 20  # reads a device block


def _affine(a: int, c: int, steps: int, device):
    """A^p and C_p = c * sum_{j<p} A^j (p = 1..steps) mod 2^64, as int64."""
    apow, cpre = [], []
    a_acc, c_acc = 1, 0
    for _ in range(steps):
        c_acc = (a_acc * c + c_acc) % (1 << 64)
        a_acc = (a_acc * a) % (1 << 64)
        apow.append(s64(a_acc))
        cpre.append(s64(c_acc))
    return (torch.tensor(apow, dtype=torch.int64, device=device),
            torch.tensor(cpre, dtype=torch.int64, device=device))


def base_table(gc_bias: float) -> bytes:
    """Upstream's 8-slot table: round(8 * gc_bias) slots alternate G and C,
    the rest A and T."""
    gc = min(max(int(gc_bias * 8.0 + 0.5), 0), 8)
    return bytes(b"GC"[k % 2] for k in range(gc)) + bytes(
        b"AT"[k % 2] for k in range(8 - gc))


def seed_offset(seed: int) -> int:
    """The seed's move of every read's LCG key (0 for seed 0)."""
    return s64(mix_int(seed) - mix_int(0))


def generate(config: dict, seed: int, device, reads=None):
    n_total = int(config["reads"] if reads is None else reads)
    L = int(config["read_length"])
    lo_q, hi_q = int(config["min_phred"]), int(config["max_phred"])
    offset = int(config["quality_offset"])
    q_lower, q_upper = int(config["quality_lower"]), int(
        config["quality_upper"])
    nd = len(str(n_total - 1)) if n_total > 1 else 1
    rs = 6 + nd + 1 + L + 3 + L + 1  # @read_<digits> \n seq \n+\n qual \n
    q_range = hi_q - lo_q
    noise_amp = q_range // 6 + 1
    apow_s, cpre_s = _affine(_A, _C, L, device)
    apow_q, cpre_q = _affine(_QA, _QC, L, device)
    lut = torch.frombuffer(bytearray(base_table(float(config["gc_bias"]))),
                           dtype=torch.uint8).to(device)
    pos = torch.arange(L, dtype=torch.int64, device=device)
    decay = (q_range * pos + (L - 1) // 2) // max(L - 1, 1) if L > 1 \
        else torch.zeros_like(pos)
    shift = seed_offset(seed)

    def sizes(lo, hi):
        return torch.full((hi - lo,), rs, dtype=torch.int64)

    def make(lo, hi):
        n = hi - lo
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        key = idx + shift
        s0 = key * s64(_A) + s64(_C)
        st = (apow_s[None, :] * s0[:, None] + cpre_s[None, :]) & _MASK63
        seq = lut[srl(st, 33) % 8]
        del st
        q0 = key * _QMUL + _QC
        qs = (apow_q[None, :] * q0[:, None] + cpre_q[None, :]) & _MASK63
        noise = srl(qs, 17) % (2 * noise_amp + 1)
        del qs
        phred = (hi_q - decay[None, :] + noise - noise_amp).clamp(lo_q, hi_q)
        qual = (phred + offset).clamp(q_lower, q_upper).to(torch.uint8)
        rows = torch.cat([
            const(b"@read_", n, device)[0], digits(idx, nd, pad=True)[0],
            const(b"\n", n, device)[0], seq, const(b"\n+\n", n, device)[0],
            qual, const(b"\n", n, device)[0]], 1)
        return rows.reshape(-1), dict(reads=n, bases=n * L)

    return write_blocks("blazeseq_throughput_100bp", n_total, _BLOCK, sizes,
                        make)
