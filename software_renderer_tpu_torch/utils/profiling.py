"""Profiling and tracing: the program's spans, and a trace recorder.

Counterpart of the JAX package's utils/profiling.py: a context manager
that records a ``torch.profiler`` trace (host and CUDA activity) and
writes it as a Chrome trace (open in Perfetto or chrome://tracing), and
named spans that show in that trace.

**Spans.** ``with span(name):`` marks a stretch of the program's host
code. Every name starts with :data:`PREFIX`. With no profiler recording
and no capture under way a span does nothing past one flag check. Under
a profiler it is a ``record_function`` range, which the Chrome trace
holds as a ``user_annotation`` event on the clock of the device events,
on the thread that launches the work inside it. The layer spans
(:data:`LAYERS`, ``sr.<layer>``) partition ``render``'s main path:

* ``sr.front``: the shading inputs and the planar front-end (K1) with
  the stream table; ``sr.clip_front`` in its place with ``clip_near``;
* ``sr.bins``: the bin build and the binned stream rows;
* ``sr.spill``: the overflow list, K3's merge and K4's resolve;
* ``sr.raster``: K2's walk (K5 and K6 on ``binned_pipeline``);
* ``sr.texture_tail``: the texture sample and combine.

**The layer map of a captured frame.** While :func:`capturing` is open
(parallel/frame_graph.py, around ``render`` inside a CUDA-graph
capture), each layer span counts the nodes of the graph being captured
at its start and end. Layer spans do not nest: one opened inside another
during a capture raises, since its start would hand the outer span's
nodes to ``other``. The result is the ordered list of (layer, nodes)
that the graph's nodes run in; nodes outside every layer span count as
``other``. A replay calls no Python, so the replay's span
carries the map in its name (:func:`encode`), and a reader of the trace
splits the replay's device operations by it in their order. The map
holds only where every node is one the device trace shows (a kernel, a
copy or a memset), checked once at the capture's end; elsewhere it is
left empty.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.autograd import profiler as _profiler

TRACE_FILE = "trace.json"
PREFIX = "sr."
LAYERS = ("front", "clip_front", "bins", "spill", "raster", "texture_tail")
_LAYER_OF = {PREFIX + layer: layer for layer in LAYERS}
_OFF = contextlib.nullcontext()
# The layer map being recorded while a capture runs, else None.
_map = None


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


def span(name: str):
    """A named span (the module docstring): a context manager that does
    nothing unless a profiler records or a capture is under way."""
    if _profiler._is_profiler_enabled or _map is not None:
        return _Span(name)
    return _OFF


class _Span:
    __slots__ = ("name", "_rf", "_map")

    def __init__(self, name: str):
        self.name = name
        self._rf = self._map = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _map is not None and self.name in _LAYER_OF:
            if _map.open is not None:
                raise RuntimeError(f"layer span {self.name} opened inside "
                                   f"{_map.open} during a capture")
            self._map = _map
            _map.mark("other")
            _map.open = self.name
        return self

    def __exit__(self, *exc):
        if self._map is not None:
            self._map.mark(_LAYER_OF[self.name])
            self._map.open = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class LayerMap:
    """The ordered (layer, nodes) of a capture; ``count()`` gives the
    nodes the graph being captured holds."""

    def __init__(self, count):
        self._count = count
        self._at = count()       # nodes put down to a layer so far
        self.layers: list[tuple[str, int]] = []
        self.open: str | None = None     # the layer span open now

    def mark(self, layer: str) -> None:
        """Put the nodes added since the last mark down to ``layer``
        (merged into the last entry where that is ``layer`` too)."""
        n = self._count()
        if n > self._at:
            if self.layers and self.layers[-1][0] == layer:
                self._at -= self.layers.pop()[1]
            self.layers.append((layer, n - self._at))
        self._at = n


@contextlib.contextmanager
def capturing(count, shown=None):
    """Record the layer map of the capture the block runs in; yields the
    :class:`LayerMap`, complete when the block ends. ``count()``: the
    nodes of the graph being captured; ``shown()``: those of them that a
    device trace shows, counted once at the end, where the map is
    emptied if the two differ."""
    global _map
    layer_map = LayerMap(count)
    _map = layer_map
    try:
        yield layer_map
        layer_map.mark("other")
        if shown is not None and shown() != count():
            layer_map.layers.clear()
    finally:
        _map = None


def encode(name: str, layers) -> str:
    """``name`` with the layer map: ``name|front=3|bins=41|...``, the
    layers in their order."""
    return "|".join([name] + [f"{layer}={n}" for layer, n in layers])
