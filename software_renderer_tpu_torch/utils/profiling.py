"""Profiling and tracing.

Counterpart of the JAX package's utils/profiling.py: a context manager
that records a ``torch.profiler`` trace (host and CUDA activity) and
writes it as a Chrome trace (open in Perfetto or chrome://tracing), a
named span that shows in that trace and in NVTX, and a stage-timing
registry that waits for the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

from .device import block_on

stage_times: dict[str, list[float]] = defaultdict(list)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) and write the Chrome trace ``log_dir/trace.json``
    (default ``log_dir``: ``sr_torch_trace`` in the temporary directory).
    Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "sr_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def span(name: str):
    """Named span: a ``record_function`` range in a profiler trace, and
    an NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def timed(name: str, result=None):
    """Host-clock a stage into ``stage_times[name]``. Before it reads the
    clock it waits (:func:`device.block_on`) for what the body appended
    to the yielded list (the last item), or else for ``result``, so the
    device work is included."""
    t0 = time.perf_counter()
    out = []
    yield out
    if out:
        block_on(out[-1])
    elif result is not None:
        block_on(result)
    stage_times[name].append(time.perf_counter() - t0)


def report() -> str:
    lines = []
    for name, times in stage_times.items():
        n = len(times)
        mean = sum(times) / n
        lines.append(f"{name}: n={n} mean={mean * 1e3:.3f} ms "
                     f"last={times[-1] * 1e3:.3f} ms")
    return "\n".join(lines)
