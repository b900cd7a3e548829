"""The program's own spans in a device trace.

The program marks its layers and entry points with ``record_function``
ranges whose names start with ``sr.`` (the program's
utils/profiling.py). The Chrome trace of ``torch.profiler`` holds them
as ``user_annotation`` events on the clock of the device events, on the
thread that launches the work inside them. :class:`Spans` is
benchlib/trace.py's ``Trace`` (the device operations and the launch
each came from) with these spans and the graph launches beside it,
which ``Trace`` does not keep, and gives:

* :meth:`Spans.replay_layers`: the device ms of each replayed frame by
  layer. A replay's span is named
  ``sr.frame_graph.replay|<layer>=<nodes>|...``: the captured graph's
  kernel, copy and memset nodes by layer, in the order they run. The
  device operations of the ``cudaGraphLaunch`` inside it (one
  correlation id) are ordered by start and cut by that map. Where their
  count is not the map's total the replay reads None, never a guess.
* :meth:`Spans.inside`: the device ms launched inside a named span, the
  device idle ms whose gap's middle lies inside it, and its host ms.

:func:`of` takes one more traced stretch of the cell's traffic after
the harness's own (the entry point's ``trace_fn``), once per run, and
only where the program has spans: the harness's ``Trace`` drops the
spans, so they are read from a stretch of their own.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

from . import program
from . import trace as tr

PREFIX = "sr."
REPLAY = "sr.frame_graph.replay"


def parse_map(name: str):
    """[(layer, nodes)] of a replay span's name, None if it has none."""
    parts = name.split("|")
    if parts[0] != REPLAY:
        return None
    out = []
    for p in parts[1:]:
        layer, _, n = p.partition("=")
        if not layer or not n.isdigit():
            return None
        out.append((layer, int(n)))
    return out


def _union(ivs):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _holds(union, starts, t) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and union[k][0] <= t <= union[k][1]


class Spans(tr.Trace):
    """A parsed Chrome trace with the program's spans; ``items`` is the
    count of frames or calls of the stretch."""

    def __init__(self, data: dict, items: int):
        super().__init__(data, items)
        evs = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
        self.spans = sorted(
            ((e["tid"], float(e["ts"]), float(e["ts"]) + float(
                e.get("dur", 0.0)), e["name"])
             for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)), key=lambda s: s[1])
        # tid -> [(start, correlation)] of the graph launches.
        self.graph_launches = collections.defaultdict(list)
        for e in evs:
            if e.get("cat") in tr._LAUNCH_CATS and "GraphLaunch" in e["name"]:
                self.graph_launches[e["tid"]].append(
                    (float(e["ts"]), e.get("args", {}).get("correlation")))

    # -- replayed frames --------------------------------------------------
    def replay_layers(self):
        """Per replay span, {layer: device ms} of its graph launch's
        operations cut by the span's layer map, or None where the
        operations do not match the map (the module docstring)."""
        by_corr = collections.defaultdict(list)
        for name, s, d, corr in self.device:
            by_corr[corr].append((s, d))
        out = []
        for tid, s, e, name in self.spans:
            layers = parse_map(name)
            if layers is None:
                continue
            corrs = [c for t, c in self.graph_launches.get(tid, ())
                     if s <= t <= e]
            ops = sorted(by_corr.get(corrs[0], ())) if len(corrs) == 1 \
                else []
            if not ops or len(ops) != sum(n for _, n in layers):
                out.append(None)
                continue
            ms, k = collections.Counter(), 0
            for layer, n in layers:
                ms[layer] += sum(d for _, d in ops[k:k + n]) / 1e3
                k += n
            out.append(dict(ms))
        return out

    def replay_ms(self, layer: str):
        """Mean device ms of ``layer`` over the stretch's replays; None
        without replays or where any replay does not match its map."""
        reps = self.replay_layers()
        if not reps or any(r is None for r in reps):
            return None
        return sum(r.get(layer, 0.0) for r in reps) / len(reps)

    # -- named spans ------------------------------------------------------
    def inside(self, name: str):
        """(device ms launched inside a span named ``name``, device idle
        ms whose gap's middle lies inside one, host ms inside them), on
        the spans' own threads; None where no such span was recorded."""
        by_tid = collections.defaultdict(list)
        for tid, s, e, n in self.spans:
            if n == name:
                by_tid[tid].append((s, e))
        if not by_tid:
            return None
        unions = {tid: _union(ivs) for tid, ivs in by_tid.items()}
        starts = {tid: [s for s, _ in u] for tid, u in unions.items()}

        def held(tid, t):
            return tid in unions and _holds(unions[tid], starts[tid], t)

        device = 0.0
        for _, s, d, corr in self.device:
            at = self.launch.get(corr)
            if at is not None and held(at[0], at[1]):
                device += d
        idle, end = 0.0, self.t0
        gaps = []
        for _, s, d, _ in self.device:
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if self.t1 > end:
            gaps.append((end, self.t1))
        for a, b in gaps:
            mid = (a + b) / 2
            if any(held(tid, mid) for tid in unions):
                idle += b - a
        host = sum(e - s for u in unions.values() for s, e in u)
        return device / 1e3, idle / 1e3, host / 1e3


def profile(fn, items: int) -> Spans:
    """Run ``fn()`` under ``torch.profiler`` (host and device) and parse
    its trace with the program's spans."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
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
    return Spans(data, items)


def program_has_spans() -> bool:
    """Whether the program marks its layers (the spans' recorder)."""
    try:
        return hasattr(program.module("utils.profiling"), "capturing")
    except ImportError:
        return False


def of(ctx):
    """The traced stretch with the program's spans for the run of
    ``ctx`` (taken at the first call, then kept), or None where the
    program has no spans or the entry point no traced stretch."""
    if "_program_spans" not in ctx.__dict__:
        got = None
        if program_has_spans() and hasattr(ctx.driver, "trace_fn"):
            fn, items = ctx.driver.trace_fn()
            got = profile(fn, items)
        ctx.__dict__["_program_spans"] = got
    return ctx.__dict__["_program_spans"]


def per_item(ctx, name: str, part: int):
    """Part ``part`` of :meth:`Spans.inside` for span ``name`` (0 device
    ms, 1 idle ms, 2 host ms) over the stretch's items, or None."""
    s = of(ctx)
    got = s.inside(name) if s is not None and s.items else None
    return None if got is None else got[part] / s.items


def replay_ms(ctx, layer: str):
    """:meth:`Spans.replay_ms` of the run's stretch, or None."""
    s = of(ctx)
    return None if s is None else s.replay_ms(layer)
