"""Device timing by CUDA events, and the card the times were taken on."""

import statistics
import subprocess
import sys

import torch


def cuda_ms(fn, reps: int = 20, batches: int = 3, warm: int = 3) -> float:
    """Milliseconds per call of fn() on the current CUDA stream: the
    median over ``batches`` of one event pair around ``reps`` calls
    issued back to back, so the device stays busy and the host's launch
    overhead hides behind earlier calls wherever a call outlasts it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
