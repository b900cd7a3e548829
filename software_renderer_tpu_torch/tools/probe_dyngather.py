"""Probe of per-lane gathers on the card (K8).

Counterpart of the JAX package's tools/probe_dyngather.py, which asked
whether Mosaic's per-lane gather beats XLA's row gather for the texture
tail. The same report on the card:

1. ``take_along_axis`` at the JAX probe's nine block shapes, through
   :func:`take_along_axis` (csrc/probe_gather.cu ``sr_take_along_axis``,
   the counterpart of ``shape_probe.kern``): exact or not;
2. the windowed lookup at 5,670 x 128 lanes on a 256 x 256 table, through
   :func:`window_lookup` (``sr_window_lookup``, the counterpart of
   ``window_kernel``): exact or not, and its time;
3. the library row gather of a [65536, 12] table at the same 725,760
   rows: its time.

    python -m software_renderer_tpu_torch.tools.probe_dyngather

Runs on the card (``run(device="cpu")`` checks the plain versions and
times nothing). Inputs come from numpy's generator with seed 0, drawn as
the JAX probe draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _cuda
from ..device import or_default

# The JAX probe's (rows, lanes, axis) block shapes.
SHAPES = ((8, 128, 0), (8, 128, 1), (16, 128, 0), (32, 128, 0),
          (64, 128, 0), (256, 128, 0), (8, 256, 1), (8, 512, 1),
          (16, 256, 1))
SEGS = 5670   # the JAX probe's compacted segment count
LANES = 128
WIN = 8       # window rows
TABLE = 256   # table side
QUAD_ROWS, QUAD_WIDTH = 65536, 12


def take_along_axis_plain(x, idx, axis: int):
    """Plain version of ``sr_take_along_axis``: one torch call."""
    return torch.take_along_dim(x, idx.long(), dim=axis)


def take_along_axis(x, idx, axis: int):
    """out[i, j] = x[idx[i, j], j] (axis 0) or x[i, idx[i, j]] (axis 1)
    for 2-D float32 ``x`` and int32 ``idx`` of one shape. CPU tensors run
    the plain version; CUDA tensors launch ``sr_take_along_axis``."""
    if x.device.type == "cpu":
        return take_along_axis_plain(x, idx, axis)
    _cuda.require(x, torch.float32, "x", ndim=2)
    _cuda.require(idx, torch.int32, "idx", device=x.device, shape=x.shape)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    out = torch.empty_like(x)
    lib = _cuda.lib()
    _cuda.launches["take_along_axis"] += 1
    _cuda.check(lib.sr_take_along_axis(
        x.data_ptr(), x.shape[0], x.shape[1], idx.data_ptr(), axis,
        out.data_ptr(), _cuda.stream_of(x)))
    return out


def window_lookup_plain(tab, y0, ty, tx):
    """Plain version of ``sr_window_lookup``: ``tab[ty, tx]``."""
    return tab[ty.long(), tx.long()]


def window_lookup(tab, y0, ty, tx):
    """``tab[ty, tx]`` for lanes whose ``ty`` lies in their segment's
    window [y0, y0 + 8). tab: [th, tw] float32; y0: [S] int32; ty, tx:
    [S, 128] int32. CPU tensors run the plain version; CUDA tensors
    launch ``sr_window_lookup``: one thread per four lanes reads their
    ``ty`` and ``tx`` with one 16-byte load each and their texels straight
    from the table, which stays in L2 (no staged window). It clamps as the
    TPU kernel's window does: row ``min(base + clamp(ty - base, 0, 7),
    th - 1)`` with ``base = clamp(y0, 0, th - 1)``, column ``clamp(tx, 0,
    tw - 1)``, so a ``ty`` outside the window reads the window's nearest
    row."""
    if tab.device.type == "cpu":
        return window_lookup_plain(tab, y0, ty, tx)
    dev = tab.device
    _cuda.require(tab, torch.float32, "tab", ndim=2)
    segs = y0.shape[0]
    _cuda.require(y0, torch.int32, "y0", device=dev, ndim=1)
    _cuda.require(ty, torch.int32, "ty", device=dev, shape=(segs, LANES),
                  align=16)
    _cuda.require(tx, torch.int32, "tx", device=dev, shape=(segs, LANES),
                  align=16)
    out = torch.empty((segs, LANES), dtype=torch.float32, device=dev)
    lib = _cuda.lib()
    _cuda.launches["window_lookup"] += 1
    _cuda.check(lib.sr_window_lookup(
        tab.data_ptr(), tab.shape[0], tab.shape[1], y0.data_ptr(),
        ty.data_ptr(), tx.data_ptr(), segs, out.data_ptr(),
        _cuda.stream_of(tab)))
    return out


def shape_inputs(rng, s: int, l: int, axis: int, device):
    """(x, idx) of one probe shape, drawn as the JAX probe draws them."""
    x = torch.from_numpy(rng.random((s, l)).astype(np.float32))
    idx = rng.integers(0, s if axis == 0 else l, size=(s, l))
    return x.to(device), torch.from_numpy(idx.astype(np.int32)).to(device)


def lookup_inputs(rng, device):
    """(tab, y0, ty, tx, quad, flat): the windowed lookup's inputs, drawn
    as the JAX probe's ``composed_probe`` draws them (every lane's row in
    its segment's 8-row window), and the row gather's table and rows."""
    tab = rng.random((TABLE, TABLE)).astype(np.float32)
    ty = rng.integers(0, TABLE, size=(SEGS, LANES))
    y0 = rng.integers(0, TABLE - WIN, size=(SEGS,))
    ty = y0[:, None] + (ty & (WIN - 1))
    tx = rng.integers(0, TABLE, size=(SEGS, LANES))
    quad = rng.random((QUAD_ROWS, QUAD_WIDTH)).astype(np.float32)
    t = lambda a, dt=np.int32: torch.from_numpy(a.astype(dt)).to(device)
    return (t(tab, np.float32), t(y0), t(ty), t(tx), t(quad, np.float32),
            t(ty * TABLE + tx, np.int64))


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs captured in
    one CUDA graph and replayed (CUDA events around the replay), so that
    the host's launch overhead does not hide a kernel shorter than it.
    ``fn`` must not synchronize with the host. The timing's own calls
    (warm-up, capture, replays) are not counted: ``_cuda.launches`` is
    left as it was found."""
    counts = dict(_cuda.launches)
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    _cuda.launches.update(counts)
    return start.elapsed_time(end) / reps


def run(device=None) -> dict:
    """The probe's report as a dict: ``shapes`` [(s, l, axis, exact)],
    ``lookup_exact``, ``lookup_ms`` and ``row_gather_ms`` (device times
    from CUDA-graph replays; None off the card)."""
    device = or_default(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    shapes = []
    for s, l, axis in SHAPES:
        x, idx = shape_inputs(rng, s, l, axis, device)
        got = take_along_axis(x, idx, axis)
        want = np.take_along_axis(x.cpu().numpy(), idx.cpu().numpy().astype(
            np.int64), axis)
        shapes.append((s, l, axis, bool(np.array_equal(got.cpu().numpy(),
                                                       want))))
    tab, y0, ty, tx, quad, flat = lookup_inputs(rng, device)
    got = window_lookup(tab, y0, ty, tx)
    want = tab.cpu().numpy()[ty.cpu().numpy(), tx.cpu().numpy()]
    out = dict(shapes=shapes,
               lookup_exact=bool(np.array_equal(got.cpu().numpy(), want)),
               lookup_ms=None, row_gather_ms=None)
    if on_card:
        out["lookup_ms"] = graph_ms(lambda: window_lookup(tab, y0, ty, tx))
        out["row_gather_ms"] = graph_ms(lambda: quad[flat])
    return out


def main(device=None) -> dict:
    """Print the probe's report (the JAX probe's lines) and return it."""
    res = run(device)
    print("shape probe:", flush=True)
    for s, l, axis, exact in res["shapes"]:
        print(f"  take_along_axis axis={axis} [{s:>3},{l:>3}]: "
              f"{'exact' if exact else 'WRONG VALUES'}", flush=True)
    print("composed probe:", flush=True)
    print(f"  windowed lookup [{SEGS}x{LANES}], C=1: "
          f"{'exact' if res['lookup_exact'] else 'WRONG VALUES'}", flush=True)
    ms = lambda v: "not measured" if v is None else f"{v:8.4f} ms"
    print(f"  windowed lookup, C=1, {SEGS * LANES} px: "
          f"{ms(res['lookup_ms'])}", flush=True)
    print(f"  row gather [{QUAD_ROWS},{QUAD_WIDTH}], {SEGS * LANES} rows: "
          f"{ms(res['row_gather_ms'])}", flush=True)
    return res


if __name__ == "__main__":
    main()
