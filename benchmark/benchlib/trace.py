"""The device trace: ``torch.profiler`` over a short stretch of a cell's
traffic, read back from its Chrome trace.

What the per-layer readers (benchmark/metrics/*.py) and the result's
``device`` and ``breakdown`` take from it:

* device intervals (kernels, copies, memsets) with their names, and
  the launch (``cuda_runtime``/``cuda_driver`` event) each came from,
  joined by correlation id;
* the busy time as the union of the device intervals, and the traced
  window from the first device or host event to the last;
* idle gaps between device intervals, each named by the host operator
  that was running at its middle;
* with ``with_stack``, the innermost frame of the program's package on
  the host thread at each launch (the attribution of a kernel to a
  module of the program).

The trace goes to a file under TMPDIR, is read and deleted.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

import torch

PACKAGE_DIR = "software_renderer_tpu_torch/"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _intervals_by_tid(events):
    """tid -> (starts, ends, names) sorted by start."""
    by = collections.defaultdict(list)
    for e in events:
        by[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(
            e.get("dur", 0.0)), e["name"]))
    out = {}
    for tid, ivs in by.items():
        ivs.sort(key=lambda x: (x[0], -x[1]))
        out[tid] = ivs
    return out


def _innermost(ivs, points, pred=lambda name: True):
    """For each of ``points`` (times), the name of the innermost of the
    nested intervals ``ivs`` (sorted by start) that holds it and whose
    name passes ``pred``, or None: one sweep with a stack of the open
    intervals."""
    order = sorted(range(len(points)), key=lambda k: points[k])
    out = [None] * len(points)
    stack, i = [], 0
    for k in order:
        ts = points[k]
        while i < len(ivs) and ivs[i][0] <= ts:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        for s, e, name in reversed(stack):
            if e >= ts and pred(name):
                out[k] = name
                break
    return out


class Trace:
    """A parsed Chrome trace of one profiled stretch."""

    def __init__(self, data: dict, items: int):
        evs = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
        self.items = items
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
              e.get("args", {}).get("correlation"))
             for e in evs if e.get("cat") in _DEVICE_CATS),
            key=lambda d: d[1])
        self.launch = {e.get("args", {}).get("correlation"):
                       (e["tid"], float(e["ts"]))
                       for e in evs if e.get("cat") in _LAUNCH_CATS}
        self.cpu_ops = _intervals_by_tid(
            [e for e in evs if e.get("cat") == "cpu_op"])
        self.python = _intervals_by_tid(
            [e for e in evs if e.get("cat") == "python_function"
             and PACKAGE_DIR in e["name"]])
        host = [float(e["ts"]) for e in evs
                if e.get("cat") not in _DEVICE_CATS]
        host_end = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in evs
                    if e.get("cat") not in _DEVICE_CATS]
        starts = host + [d[1] for d in self.device]
        ends = host_end + [d[1] + d[2] for d in self.device]
        self.t0 = min(starts) if starts else 0.0
        self.t1 = max(ends) if ends else 0.0
        self._modules = None

    # -- whole-window readings ------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of the device intervals)."""
        total, end = 0.0, None
        for _, s, d, _ in self.device:
            e = s + d
            if end is None or s > end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def launches(self) -> int:
        """Device operations: kernels, copies and memsets."""
        return len(self.device)

    def top_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most
        time, summed by name."""
        acc = collections.Counter()
        for name, _, d, _ in self.device:
            acc[name[:120]] += d / 1e6
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n=10):
        """[[name, seconds]] of the idle time between device operations,
        summed by the host operator running at each gap's middle on the
        busiest host thread ("host: no operator" where none ran), the
        longest first."""
        end, gaps = self.t0, []
        for _, s, d, _ in self.device:
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if self.t1 > end:
            gaps.append((end, self.t1))
        names = [None] * len(gaps)
        if self.cpu_ops:
            main = max(self.cpu_ops, key=lambda t: len(self.cpu_ops[t]))
            names = _innermost(self.cpu_ops[main],
                               [(a + b) / 2 for a, b in gaps])
        acc = collections.Counter()
        for (a, b), name in zip(gaps, names):
            acc[f"host: {name[:100]}" if name else "host: no operator"] += \
                (b - a) / 1e6
        return [[k, v] for k, v in acc.most_common(n)]

    # -- attribution ------------------------------------------------------
    def device_ms(self, name_re: str | None = None) -> float:
        """Device ms of the operations whose name matches ``name_re``
        (all without)."""
        rx = re.compile(name_re) if name_re else None
        return sum(d for name, _, d, _ in self.device
                   if rx is None or rx.search(name)) / 1e3

    def _per_launch(self, host, pred=lambda name: True):
        """For each device operation, the innermost interval of ``host``
        (tid -> intervals) passing ``pred`` at its launch, or None."""
        by_tid = collections.defaultdict(list)
        for k, (_, _, _, corr) in enumerate(self.device):
            at = self.launch.get(corr)
            if at is not None and at[0] in host:
                by_tid[at[0]].append((k, at[1]))
        out = [None] * len(self.device)
        for tid, pts in by_tid.items():
            names = _innermost(host[tid], [t for _, t in pts], pred)
            for (k, _), name in zip(pts, names):
                out[k] = name
        return out

    def modules(self):
        """Per device operation, '<path inside the package>:<function>'
        of the innermost frame of the program's package on the host at
        its launch, or None."""
        if self._modules is None:
            rx = re.compile(re.escape(PACKAGE_DIR)
                            + r"(\S+?\.py)\(\d+\): (\S+)")
            self._modules = []
            for name in self._per_launch(self.python):
                m = rx.search(name) if name else None
                self._modules.append(f"{m.group(1)}:{m.group(2)}"
                                     if m else None)
        return self._modules

    def has_stacks(self) -> bool:
        return any(self.python.values())

    def attributed_ms(self, pred) -> float | None:
        """Device ms of the operations for which ``pred(name, module)``
        holds; None when the trace has no Python stacks."""
        if not self.has_stacks():
            return None
        return sum(d for (name, _, d, _), mod in zip(self.device,
                                                     self.modules())
                   if pred(name, mod)) / 1e3

    def under_cpu_op(self, prefix: str) -> float:
        """Device ms of the operations launched inside a host operator
        whose name starts with ``prefix`` (on the launching thread)."""
        inside = self._per_launch(self.cpu_ops,
                                  lambda n: n.startswith(prefix))
        return sum(d for (_, _, d, _), hit in zip(self.device, inside)
                   if hit) / 1e3


def profile(fn, items: int, *, with_stack: bool = False) -> Trace:
    """Run ``fn()`` under ``torch.profiler`` (host and device) and parse
    its trace; ``items`` is the count of frames or steps ``fn`` does."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                with_stack=with_stack) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return Trace(data, items)
