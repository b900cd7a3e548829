"""The compiled frame: ``render`` captured once into a CUDA graph and
replayed per transform.

Counterpart of the JAX package's ``jax.jit(render)`` (render.py:458),
which its ``render_batch`` (a jitted ``vmap``) and
``render_batch_chunked`` (a jitted ``scan``) run. A frame of the port
makes no host sync and no host-to-card copy (ops/binning.py keeps every
count on the device), so its ~265 launches can be recorded once and
replayed as one graph: the host then pays one launch a frame, and the
device never waits for it.

:class:`FrameGraph` renders the first frame of a pass eagerly (the
warm-up: kernel library, allocator, device constants), then captures
``render`` of the same pass with its transform read from a static
buffer, on the capture's side stream. Every later frame of the same key
copies its transform into that buffer and replays the graph into the
graph's static outputs, which the next replay overwrites (callers copy
them out). The key is the pass's static structure: its shapes and
flags, the backend, the sampler route and the data pointers of the
mesh, texture, light, model and flat colour, whose memory the graph
reads at every replay. A new key means a new capture.

A caller whose pass is fixed but for its transform (utils/display.py's
``FrameLoop``) passes the transform apart, ``graph(rp, transform=t)``,
and the same pass object each frame: a call that repeats the last call's
pass so, under the same backend and sampler route, with no tensor of the
pass or of the transform requiring grad and a transform of the same
shape and dtype, replays the last call's capture without building its
key. The pass is then taken as unchanged since that call: a tensor of it
swapped for another, or a CPU flat colour edited in place, is seen only
by a call with a new pass object.

A FrameGraph keeps each capture until it holds more than
:data:`MAX_CAPTURES`, then drops the least recently used one. A kept
capture keeps its pass alive (mesh, texture, light and model: the
memory the graph reads, which must not be freed and handed to another
pass under the same data pointers) and its graph's memory reserved; the
bound is what keeps a long-running caller from holding every mesh it
ever rendered. All captures of one FrameGraph allocate from one graph
memory pool, on one capture stream (the allocator hands a freed block
only to an allocation on the stream that freed it): replays run one at
a time on the caller's stream, so the captures share their
intermediates, and the memory of a dropped capture goes back to the
pool for the next capture. A pool of a capture's own would go back to
the card, once its graph is dropped, only through ``empty_cache`` or
an allocation that fails outside a capture.

Frames a graph cannot hold run eagerly through ``render``, which still
runs on the card: an input that requires grad (the autograd graph is
built per call), the ``"adaptive"`` sampler route (it reads one
predicate on the host, ops/texture.py), lines and points, the
``reference``/``pallas`` backends, and CPU tensors. :data:`routes`
counts every frame by its route.

The kernel wrappers count their launches in Python (``_cuda.launches``),
and a replay calls no wrapper: the launches a capture records are taken
back out of the counters and credited again on each replay, so the
counters hold the launches the device ran.

Spans (utils/profiling.py): ``sr.frame_graph.key`` around the host work
a frame pays before anything launches (whether a graph can hold it, its
key and the capture's lookup, or the check that the pass repeats),
``sr.frame_graph.capture`` around a key's first frame and its capture,
and ``sr.frame_graph.replay|<layer map>``
around each replay, which holds the transform's copy and, nested in it,
``sr.frame_graph.launch`` around the graph's launch alone: the replay's
host time less the launch's is the copy's. Every capture records its
layer map, the graph's nodes by layer in their order, and a replay's
span carries it in its name, so a profiler's trace splits each
replay's device operations by layer.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from .. import _cuda
from ..framebuffer import Framebuffer
from ..ops import texture
from ..render import RenderPass, render
from ..utils import profiling
from ..utils.profiling import span

# Frames since the last reset_routes(), by route: "capture" rendered
# eagerly and then captured, "replay" replayed from a graph, "eager"
# rendered by render() because no graph can hold them.
routes = {"capture": 0, "replay": 0, "eager": 0}

# Captures dropped by every FrameGraph since the process started, the
# least recently used first, once a FrameGraph held more than
# MAX_CAPTURES.
evictions = 0

# The most captures a FrameGraph keeps: enough for a caller that renders
# a few scenes, or a scene under a few sampler routes, in turn. The
# captures share their intermediates, so each beyond the first adds
# about its outputs: 8 passes of config 4 at 1920x1080 took the card's
# reserved memory to 1.4 GB in all (NVIDIA H100).
MAX_CAPTURES = 8

# Backends whose triangle path a graph holds.
_BACKENDS = ("auto", "binned")
# RenderPass fields that hold tensors (:func:`_parts` lists them).
_TENSORS = ("mesh", "transform", "light", "texture", "model", "flat_color")


def reset_routes() -> None:
    for k in routes:
        routes[k] = 0


def _parts(rp: RenderPass) -> dict:
    """The pass's tensors (None where absent) and options, by name."""
    mesh, tex, light = rp.mesh, rp.texture, rp.light
    parts = {f"mesh.{f.name}": getattr(mesh, f.name)
             for f in dataclasses.fields(mesh)}
    if tex is not None:
        parts.update({"texture.data": tex.data, "texture.table": tex.table,
                      "texture.texels": tex.texels,
                      "texture.filter": tex.filter, "texture.wrap": tex.wrap})
    if light is not None:
        parts.update({f"light.{f.name}": getattr(light, f.name)
                      for f in dataclasses.fields(light)})
    parts.update(model=rp.model, flat_color=rp.flat_color)
    return parts


def _tensors(rp: RenderPass) -> list:
    """The pass's tensors but its transform."""
    return [t for t in _parts(rp).values() if isinstance(t, torch.Tensor)]


def capturable(rp: RenderPass, backend: str) -> bool:
    """Whether a graph can hold ``render(rp, backend)``: triangles on
    ``auto``/``binned`` on the card, no input that requires grad, and a
    sampler route other than ``"adaptive"``."""
    tensors = _tensors(rp) + [rp.transform]
    return (rp.primitive == "triangle" and backend in _BACKENDS
            and rp.mesh.positions.is_cuda
            and not any(t.requires_grad for t in tensors)
            and not (rp.shading == "textured" and rp.texture is not None
                     and texture.TEX_WINDOWED == "adaptive"))


def _key(rp: RenderPass, backend: str) -> tuple:
    """The static structure of ``render(rp, backend)``: what a capture
    bakes in. Host tensors (a CPU flat colour) enter by value."""
    def sig(v):
        if not isinstance(v, torch.Tensor):
            return v
        return (v.data_ptr(), tuple(v.shape), v.dtype, v.device,
                tuple(v.flatten().tolist()) if v.device.type == "cpu"
                else None)

    opts = tuple((f.name, getattr(rp, f.name))
                 for f in dataclasses.fields(rp) if f.name not in _TENSORS)
    return (backend, texture.TEX_WINDOWED, opts,
            tuple(rp.transform.shape), rp.transform.dtype,
            tuple((k, sig(v)) for k, v in sorted(_parts(rp).items())))


@dataclasses.dataclass
class _Capture:
    graph: "torch.cuda.CUDAGraph"
    transform: torch.Tensor      # the static [4, 4] buffer the graph reads
    out: Framebuffer             # the graph's static outputs
    launches: dict               # kernel launches of one replay
    rp: RenderPass               # keeps the memory the graph reads alive
    layers: tuple                # the layer map: ((layer, nodes), ...)
    replay_span: str             # the replay's span, the map in its name


@dataclasses.dataclass
class _Repeat:
    """What a call that passed its transform apart leaves for the next:
    its pass object and what its capture was found under."""
    rp: RenderPass
    backend: str
    route: str                   # texture.TEX_WINDOWED
    tensors: list                # the pass's, for requires_grad
    shape: torch.Size            # the transform's shape and dtype
    dtype: torch.dtype
    cap: _Capture

    def holds(self, rp: RenderPass, backend: str, t: torch.Tensor) -> bool:
        return (rp is self.rp and backend == self.backend
                and texture.TEX_WINDOWED == self.route
                and t.shape == self.shape and t.dtype == self.dtype
                and not t.requires_grad
                and not any(x.requires_grad for x in self.tensors))


class FrameGraph:
    """``render(rp, backend)`` per transform, replayed from one CUDA
    graph per key (the module docstring). Calling it returns the frame's
    Framebuffer; on a replay that is the graph's static output, valid
    until the next call.

    A capture outlives the call that made it: up to
    :data:`MAX_CAPTURES` are kept, each with its pass (the memory of its
    mesh, texture, light and model) alive, and the least recently used
    one beyond that is dropped, counted in :data:`evictions`."""

    def __init__(self):
        self._captures: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._streams: dict = {}      # the capture stream of each device
        self._repeat = None           # a _Repeat, or None

    def __call__(self, rp: RenderPass, backend: str = "auto",
                 transform: torch.Tensor | None = None) -> Framebuffer:
        """The frame of ``rp``, under ``transform`` in place of
        ``rp.transform`` where it is given (the module docstring)."""
        global evictions
        last, self._repeat = self._repeat, None
        t = rp.transform if transform is None else transform
        with span("sr.frame_graph.key"):
            if (transform is not None and last is not None
                    and last.holds(rp, backend, t)):
                cap = last.cap
            else:
                last = None
                whole = (rp if transform is None
                         else dataclasses.replace(rp, transform=t))
                graphed = capturable(whole, backend)
                if graphed:
                    key = _key(whole, backend)
                    cap = self._captures.get(key)
        if last is not None:
            # The last call's capture, still the most recently used.
            self._repeat = last
        elif not graphed:
            routes["eager"] += 1
            return render(whole, backend)
        elif cap is None:
            with span("sr.frame_graph.capture"):
                fb = render(whole, backend)
                cap = self._captures[key] = self._capture(whole, backend)
            routes["capture"] += 1
            # Dropped after the new capture is in, so that the pool keeps
            # a live graph.
            while len(self._captures) > MAX_CAPTURES:
                self._captures.popitem(last=False)
                evictions += 1
            self._remember(rp, backend, transform, cap)
            return fb
        else:
            self._captures.move_to_end(key)
            self._remember(rp, backend, transform, cap)
        with span(cap.replay_span):
            cap.transform.copy_(t)
            with span("sr.frame_graph.launch"):
                cap.graph.replay()
        for k, n in cap.launches.items():
            _cuda.launches[k] += n
        routes["replay"] += 1
        return cap.out

    def _remember(self, rp: RenderPass, backend: str,
                  transform: torch.Tensor | None, cap: _Capture) -> None:
        """Keep a call that passed its transform apart for a repeat."""
        if transform is not None:
            self._repeat = _Repeat(rp, backend, texture.TEX_WINDOWED,
                                   _tensors(rp), transform.shape,
                                   transform.dtype, cap)

    def _capture(self, rp: RenderPass, backend: str) -> _Capture:
        if not self._captures:
            # The allocator takes no more graphs into a shared pool whose
            # graphs are all gone.
            self._pool = torch.cuda.graph_pool_handle()
        dev = rp.mesh.positions.device
        static_t = torch.empty((4, 4), dtype=torch.float32, device=dev)
        static_t.copy_(rp.transform)
        crp = dataclasses.replace(rp, transform=static_t)
        before = dict(_cuda.launches)
        # capture_begin/end on a side stream, as torch.cuda.graph does,
        # without its synchronize and empty_cache: freeing the allocator's
        # cache would cost every later frame its allocations again. One
        # stream for every capture, as torch.cuda.graph keeps one, so that
        # the captures share the pool's blocks (the module docstring).
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                with profiling.capturing(
                        lambda: _cuda.capture_nodes(side),
                        lambda: _cuda.capture_nodes(side, typed=True)
                ) as layer_map:
                    out = render(crp, backend)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        # Nothing ran during the capture: its launches count per replay.
        counted = {k: _cuda.launches[k] - before[k] for k in before}
        _cuda.launches.update(before)
        layers = tuple(layer_map.layers)
        return _Capture(graph, static_t, out,
                        {k: n for k, n in counted.items() if n}, rp, layers,
                        profiling.encode("sr.frame_graph.replay", layers))
