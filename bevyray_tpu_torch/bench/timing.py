"""What the benches share: the device, its sync, its name, the timing loop
and the kernel's launch count.

The JAX repository's bench scripts define these each for themselves:
``_time`` (``scripts/bench_matrix.py:23``), ``p50_ms``
(``scripts/bench_orbit.py:57``), and a host copy of one pixel as the sync
(``bench.py:32-35``), which waits for the one array it copies. Here
:func:`sync` is ``torch.cuda.synchronize()``: it waits for everything queued
on the card, and it is the only wait the timed loops take. Rows name the card
by :func:`card_fields` where JAX printed ``str(jax.devices()[0])``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import subprocess
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

from ..core.types import resolve_device
from ..kernels.cuda import megakernel

_PACKAGE = Path(__file__).resolve().parents[1]


def device_arg(description: str) -> torch.device:
    """The ``--device`` of a bench's command line, resolved."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, an error "
                        "without one; cpu runs the plain PyTorch versions)")
    return resolve_device(p.parse_args().device)


def sync(device) -> None:
    """Wait for all work queued on ``device`` when it is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def card_fields(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (e.g. "NVIDIA H100 80GB
    HBM3, 700.00 W"); the device type for a device that is no card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return out.stdout.strip().splitlines()[dev.index or 0]


def p50_ms(ts) -> float:
    return round(float(np.percentile(ts, 50)) * 1e3, 2)


def _time(render, n=3):
    """``render(seed)`` once to warm up, then ``n`` timed frames at seeds
    1..n, each ended by :func:`sync`. Returns the p50 in seconds and the
    mean of the timed frames' device-counted segments."""
    f = render(0)
    sync(f.image.device)
    ts, rays = [], []
    for i in range(n):
        t0 = time.perf_counter()
        f = render(i + 1)
        sync(f.image.device)
        ts.append(time.perf_counter() - t0)
        rays.append(float(f.rays_traced))
    return float(np.percentile(ts, 50)), float(np.mean(rays))


def launch_count() -> int:
    """Launches of the CUDA kernel in this process so far."""
    return megakernel.render_tiles.launches


def launches_since(before: int, name: str, device) -> int:
    """Kernel launches since the count ``before``; a row on the card that
    launched none raises (on the CPU the plain version runs: 0)."""
    n = launch_count() - before
    if torch.device(device).type == "cuda" and n == 0:
        raise RuntimeError(f"{name}: the row launched no CUDA kernel")
    return n


@contextlib.contextmanager
def host_syncs(device, sites: list):
    """Append to ``sites`` the ``file:line`` (in this package, outside the
    benches) of each call in the block that waits for the card: torch's sync
    debug mode warns at each such call. Nothing is recorded off a card."""
    if torch.device(device).type != "cuda":
        yield
        return

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if Path(f.filename).name != "warnings.py"]
        for frame in reversed(stack):
            path = Path(frame.filename).resolve()
            if _PACKAGE in path.parents and path.parent.name != "bench":
                sites.append(f"{path.relative_to(_PACKAGE.parent)}:"
                             f"{frame.lineno}")
                return
        sites.append(" < ".join(f"{f.filename}:{f.lineno} {f.name}"
                                for f in stack[:-4:-1]))

    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # The first switch in a process warns of itself: not recorded.
        warnings.showwarning = lambda *args, **kwargs: None
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(previous)
