"""The card's peaks.

Bytes: the H100 SXM data sheet's 3.35 TB/s of HBM3. Operations: there is
no data-sheet figure for int32; the peak is derived as the SMs' int32 lanes
(64 an SM on sm_90) times the largest SM clock that nvidia-smi reads
(1,980 MHz on the H100 SXM), which the run prints beside it."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
DEFAULT_SM_CLOCK_HZ = 1.98e9


def sm_clock_hz() -> float:
    """The largest SM clock nvidia-smi reads, or the H100 SXM's 1.98 GHz."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return DEFAULT_SM_CLOCK_HZ


def int32_ops_per_s(sms: int, clock_hz: float) -> float:
    return sms * INT32_LANES_PER_SM * clock_hz


def bound_s(n_bytes: float, ops: float, sms: int, clock_hz: float) -> float:
    """The least time the card needs to move `n_bytes` and do `ops` int32
    operations: the larger of the two."""
    return max(n_bytes / HBM_BYTES_PER_S,
               ops / int32_ops_per_s(sms, clock_hz))
