"""Device timing by CUDA events, and the card the times were taken on."""

import statistics
import subprocess
import sys
import time

import torch

# the spin before a timed batch: at most this long, at >= 1 cycle per ns
MAX_SPIN_S = 0.05
SPIN_CYCLES_PER_S = 2e9


def cuda_ms(fn, reps: int = 20, batches: int = 3, warm: int = 3) -> float:
    """Milliseconds per call of fn() on the current CUDA stream: the
    median over ``batches`` of one event pair around ``reps`` calls
    issued back to back. Each batch is queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts twice the host's time to issue
    it (the quickest warm-up call's, at most ``MAX_SPIN_S``), so the
    calls run back to back on the device and a call shorter than its own
    launch on the host is timed by the device, not by the host."""
    host_s = 0.0
    for i in range(warm):
        t0 = time.perf_counter()
        fn()
        t = time.perf_counter() - t0
        host_s = t if i == 0 else min(host_s, t)
    torch.cuda.synchronize()
    spin = int(min(MAX_SPIN_S, 2.0 * host_s * reps) * SPIN_CYCLES_PER_S)
    per_call = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require_card(tool: str) -> bool:
    """True with a CUDA card; else says so on stderr (the micro-benchmarks
    time kernels that have no CPU mode, so they never fall back)."""
    if torch.cuda.is_available():
        return True
    print(f'{tool}: needs an NVIDIA GPU (no CUDA device)', file=sys.stderr)
    return False
