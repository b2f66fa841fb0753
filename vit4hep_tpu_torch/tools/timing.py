"""Device timing and work bounds for the port's kernels on an NVIDIA H100.

One definition of the card's peak rates, of the least time a piece of work
can take on it, and of the spin-kernel timer, shared by ``chip_smoke.py``
and :mod:`vit4hep_tpu_torch.tools.megakernel_residue`.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores
HBM_BYTES_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
SPIN_HZ = 1.98e9  # the SM's boost clock: torch.cuda._sleep counts its cycles


def work_bound(nbytes, flops, rate):
    """(least ms for the work, what bounds it): the larger of the bytes over
    the HBM rate and the operations over the peak ``rate`` of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps=10, warmup=2, repeat=1):
    """Median over ``reps`` trials of the device ms of one call of ``fn``,
    from CUDA events around ``repeat`` calls queued back to back. A spin
    kernel queued just before the start event holds the card until the host
    has queued the whole trial, so that a kernel shorter than the host's
    work to launch it is timed on the device, not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(max(2 * host_s, 1e-3), 0.2) * SPIN_HZ)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return float(np.median(times))


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
