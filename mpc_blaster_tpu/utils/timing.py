"""Per-call latency on the host clock.

JAX dispatches asynchronously: a jitted call returns before the device has
finished. Each sample here is the host clock around one call whose outputs
are waited on with `jax.block_until_ready`, so it covers dispatch, device
execution and the wait — what a caller of the controller sees per tick.
`card_identity` names the card each time was taken on.
"""
from __future__ import annotations

import subprocess
import time

import numpy as np

import jax


def call_times(fn, reps: int = 20, warmup: int = 2) -> np.ndarray:
    """Seconds of each of `reps` calls of `fn()`, after `warmup` calls.

    `fn` must return a jax pytree; each call is timed to the end of
    `jax.block_until_ready` on its outputs.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    out = np.empty(reps, np.float64)
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out[i] = time.perf_counter() - t0
    return out


def device_time(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median seconds per `fn()` call (see `call_times`)."""
    return float(np.median(call_times(fn, reps=reps, warmup=warmup)))


def card_identity() -> str:
    """Name and power limit of each NVIDIA card, from `nvidia-smi` in a
    child process, to print beside every time taken on it (a card set
    below its maximum power runs slower under load)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return " | ".join(lines) or f"nvidia-smi gave nothing (rc={r.returncode})"
