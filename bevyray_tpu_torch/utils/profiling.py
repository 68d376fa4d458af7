"""Profiling & observability — what the reference lacks entirely (SURVEY.md §5:
no GPU timing, ``timestamp_writes: None``; labeled passes only).

Counterpart of ``bevyray_tpu/utils/profiling.py``: the port's spans
(:func:`span`) are ``torch.profiler.record_function`` ranges while a torch
profiler records, the device trace is a ``torch.profiler.profile`` (CUDA
activity on a card) written into a directory as a Chrome/TensorBoard
trace, and the frame-timing harness synchronizes the card where the JAX
package blocks on its arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# The namespace of every profiler range the port opens. The repository's
# trace reader (``benchmark/timeline.py``) collects ranges under it as host
# spans, on the profiler's clock, and counts any other range as work on the
# device.
SPAN_PREFIX = "bench."

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``SPAN_PREFIX + name`` while a torch profiler
    records; otherwise one shared no-op context manager, so that an
    untraced frame pays a flag check and no call into torch."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def device_kernels(prof) -> list:
    """The ``key_averages()`` entries of a finished torch profile that are
    the card's work: those on the CUDA timeline, less the copies of the
    profiler ranges (:func:`span`) that the profiler puts there too."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (CPU ops, and CUDA kernels when a card is present)
    and write the trace into ``log_dir`` for TensorBoard or chrome://tracing;
    yields the profiler, whose ``key_averages()`` sums the device time."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def synchronize(out) -> None:
    """Wait for ``out`` (a FrameResult or a tensor) when it lies on a card:
    the counterpart of ``jax.block_until_ready``."""
    t = getattr(out, "image", out)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class FrameStats:
    times_s: List[float]
    rays_per_frame: float

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.times_s, 50) * 1e3)

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.times_s, 99) * 1e3)

    @property
    def mrays_per_sec(self) -> float:
        p50 = np.percentile(self.times_s, 50)
        return float(self.rays_per_frame / p50 / 1e6)

    def summary(self) -> dict:
        return {"p50_frame_ms": round(self.p50_ms, 2),
                "p99_frame_ms": round(self.p99_ms, 2),
                "mrays_per_sec": round(self.mrays_per_sec, 2),
                "rays_per_frame": int(self.rays_per_frame)}


def time_frames(render_fn: Callable[[int], object], n_frames: int = 8,
                warmup: int = 1, rays_per_frame: Optional[float] = None) -> FrameStats:
    """Time ``render_fn(seed)`` over ``n_frames`` after ``warmup`` calls,
    host clock around each call and the card's synchronize.

    ``render_fn`` returns a FrameResult or a tensor.
    """
    last = None
    for i in range(warmup):
        last = render_fn(i)
        synchronize(last)
    if rays_per_frame is None:
        rays_per_frame = float(getattr(last, "rays_traced", 0.0)) if last is not None else 0.0
    times = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        out = render_fn(warmup + i)
        synchronize(out)
        times.append(time.perf_counter() - t0)
    return FrameStats(times_s=times, rays_per_frame=rays_per_frame)
