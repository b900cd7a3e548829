"""Benchmark harness: frame timing, FPS, Mtri/s.

Counterpart of the JAX package's utils/timing.py. Each call is timed on
the host clock around work that ends in :func:`device.block_on`, and
the device's own time by CUDA events around the same calls when its
output lies on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import _cuda
from .device import _leaves, block_on


@dataclass
class BenchResult:
    name: str
    frames: int
    p50_ms: float
    mean_ms: float
    fps: float
    mtri_s: float
    compile_s: float
    # Mean device ms per frame by CUDA events; None when the output is on
    # the CPU.
    device_ms: Optional[float] = None

    def __str__(self):
        dev = ("" if self.device_ms is None
               else f" | device {self.device_ms:.3f} ms")
        return (f"{self.name}: p50 {self.p50_ms:.3f} ms | mean "
                f"{self.mean_ms:.3f} ms{dev} | {self.fps:.1f} FPS | "
                f"{self.mtri_s:.1f} Mtri/s (first call {self.compile_s:.1f}s)")


def _cuda_device(out):
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def bench_frame(fn, args_fn, *, name: str = "frame", triangles: int = 0,
                frames_per_call: int = 1, warmup: int = 2,
                iters: int = 20) -> BenchResult:
    """Time fn(*args_fn(i)) over ``iters`` calls.

    args_fn(i) -> args tuple (varying per iteration, so no result can be
    reused across frames). ``compile_s`` is the first call's time: the
    kernels' build (at first use) and first launches.
    """
    t0 = time.perf_counter()
    out = block_on(fn(*args_fn(0)))
    compile_s = time.perf_counter() - t0
    dev = _cuda_device(out)
    for i in range(warmup):
        out = fn(*args_fn(i + 1))
    block_on(out)
    times, dev_ms = [], []
    for i in range(iters):
        events = None
        if dev is not None:
            events = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
            events[0].record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        out = fn(*args_fn(i + warmup + 1))
        if events is not None:
            events[1].record(torch.cuda.current_stream(dev))
        block_on(out)
        times.append(time.perf_counter() - t0)
        if events is not None:
            dev_ms.append(events[0].elapsed_time(events[1]))
    per_frame = np.asarray(times) / frames_per_call
    p50 = float(np.percentile(per_frame, 50))
    mean = float(per_frame.mean())
    return BenchResult(
        name=name, frames=iters * frames_per_call,
        p50_ms=p50 * 1e3, mean_ms=mean * 1e3, fps=1.0 / p50,
        mtri_s=triangles / p50 / 1e6 if triangles else 0.0,
        compile_s=compile_s,
        device_ms=(float(np.mean(dev_ms)) / frames_per_call if dev_ms
                   else None))


def enable_compile_cache(path: str | None = None) -> Path:
    """Keep the built kernel library (and the native runtime) in ``path``
    (default: the package's ``_build/``), so a later process loads it
    instead of building it. Returns the directory."""
    _cuda.BUILD_DIR = (_cuda.DEFAULT_BUILD_DIR if path is None
                       else Path(path).resolve())
    return _cuda.BUILD_DIR
