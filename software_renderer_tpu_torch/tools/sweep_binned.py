"""Block-shape sweep of the bin walk (K2 and K5, csrc/fused.cu), and its
time against another version of the same sources.

    python -m software_renderer_tpu_torch.tools.sweep_binned \
        [--baseline DIR]

Builds csrc/fused.cu once per variant of :data:`SHAPES` (its rows per
warp rectangle and resident blocks per SM substituted), each into a
library of its own, all ``nvcc`` processes started together; with
``--baseline``, also ``DIR/fused.cu`` and ``DIR/binned_vis.cu`` as they
are: the csrc/ of a commit before the bbox cull, whose entries take no
bbox (for example the parent commit's, unpacked with ``git archive`` into
a git-ignored directory). The inputs are chip_smoke.py's phase-3 shapes at
config 4's full size (frame 0, 1920x1080): K2 static over 4-band bins,
K2 seeded on the kmax=1 spill set from its overflow seeds, and K5 over
whole-tile bins; and K2 static and K5 with every bin empty (the blocks'
start, the epilogue and the writes, without the walk). Every library's
output must equal the package's kernel bit for bit (depth, ids and
planes).

Times: device time of REPS calls captured in one CUDA graph and replayed
(the kernels are shorter than their wrappers' host overhead), in turns
(baseline, the variants, the variants again in reverse, baseline), with
each kernel's registers and spills from ``-Xptxas -v`` and each input's
records per bin (p50, p99, max). Prints the card line and one JSON line.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from .. import _cuda
from ..models import scenes
from ..ops import binning as tb
from ..ops import frontend as fe
from ..ops.rasterize_kernel import _poison_row, visibility_merge_kernel
from ..ops.shading import _chan_offset, fused_output_channels
from ..render import triangle_inputs
from .probe_dyngather import graph_ms
from .sweep_visibility import _build, _regs

# Variants: the constants of csrc/fused.cu to substitute (rows per block
# dividing a 16-row band, columns of a warp rectangle dividing 32, pixels
# per thread, resident blocks per SM; threads = 2048 x rows / 16 / pixels,
# at most 1024).
KEYS = ("kSlabH", "kRectW", "kPix", "kMinBlocks")
SHAPES = ((16, 32, 16, 6), (16, 32, 8, 4), (16, 32, 4, 2), (16, 32, 2, 1),
          (16, 16, 2, 1), (16, 16, 4, 2), (16, 8, 2, 1), (8, 32, 2, 2),
          (8, 16, 2, 2), (8, 8, 1, 1), (8, 32, 1, 1), (4, 32, 1, 2))
# The render path's pair budget for culled scenes (render.py).
BUDGET = 0.85
REPS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int
# The entries of csrc/ before the bbox cull.
_LEGACY = {"sr_fused": (_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
           "sr_binned_vis": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P)}


def _variant(shape, out_dir: Path) -> Path:
    """fused.cu with the constants of ``shape`` (KEYS) substituted."""
    src = (_cuda.CSRC / "fused.cu").read_text()
    for key, val in zip(KEYS, shape):
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{key} not found in fused.cu")
    path = out_dir / f"walk_{_name(shape)}.cu"
    path.write_text(src)
    return path


def _name(shape) -> str:
    return "s{}w{}p{}b{}".format(*shape)


def _load(so: Path, legacy: bool):
    lib = ctypes.CDLL(str(so))
    sigs = _LEGACY if legacy else {k: _cuda._SIGNATURES[k] for k in _LEGACY}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
    return lib


def percentiles(bin_start) -> dict:
    """Records per bin of a CSR list: p50, p99, max, and the bin count."""
    counts = (bin_start[1:] - bin_start[:-1]).float()
    q = torch.quantile(counts, torch.tensor([0.5, 0.99],
                                            device=counts.device))
    return dict(bins=counts.numel(), p50=float(q[0]), p99=float(q[1]),
                max=int(counts.max()))


def inputs(dev) -> dict:
    """{case: (kind, rows, bin_start, bbox, kwargs)} at chip_smoke.py's
    phase-3 shapes."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    bbox = fe.bbox_table(ps)
    shade = dict(params=prm, chans=chans, has_light=True, has_texture=True,
                 bands=4, width=w, height=h)
    info = tb.build_bins(ps, width=w, height=h, kmax=48,
                         pair_budget_factor=BUDGET, bands=4)
    info1 = tb.build_bins(ps, width=w, height=h, kmax=1,
                          pair_budget_factor=BUDGET, bands=4)
    ov = torch.nonzero(info1.overflow_mask).squeeze(1).to(torch.int32)
    rec = tb.gather_stream(fe.pack_records_planar(ps, 128), ov,
                           _poison_row(dev)).contiguous()
    z0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    z3, i3 = visibility_merge_kernel(rec, z0, i0, width=w, height=h)
    # The static list's slot map also indexes the compact list: its first
    # rows are the same ids in the same order.
    _, slots = tb.overflow_ids(info1.overflow_mask)
    g4 = tb.resolve_merge_kernel(
        tb.gather_stream(table, ov, poison).contiguous(), i3,
        torch.zeros((a, h, w), device=dev), width=w, height=h, slots=slots)
    info_b = tb.build_bins(ps, width=w, height=h, pair_budget_factor=BUDGET)
    rows = lambda i: tb.gather_stream(table, i.ids, poison).contiguous()
    # The same launches with every bin empty: what is left is the blocks'
    # start, the epilogue and the writes.
    empty = lambda i: torch.zeros_like(i.bin_start)
    return {
        "fused_static": ("fused", rows(info), info.bin_start, bbox,
                         dict(shade, seeds=None)),
        "fused_seeded": ("fused", rows(info1), info1.bin_start, bbox,
                         dict(shade, seeds=(z3, i3, g4))),
        "binned_vis": ("vis", rows(info_b), info_b.bin_start, bbox,
                       dict(width=w, height=h, bands=1)),
        "fused_static_no_records": ("fused", rows(info), empty(info), bbox,
                                    dict(shade, seeds=None)),
        "binned_vis_no_records": ("vis", rows(info_b), empty(info_b), bbox,
                                  dict(width=w, height=h, bands=1)),
    }


def _call(lib, legacy, kind, rows, starts, bbox, kw):
    """One call of ``lib``'s kernel on a case."""
    if not legacy:
        if kind == "vis":
            return tb.card_binned_vis(lib, rows, starts, bbox, y_start=0,
                                      tile_h=tb.TILE_H, **kw)
        kw = dict(kw)
        return tb.card_fused(lib, rows, starts, kw.pop("params"), bbox,
                             y_start=0, tile_h=tb.TILE_H, **kw)
    w, h, bands = kw["width"], kw["height"], kw["bands"]
    nbins, gw = tb._grid(w, h, tb.TILE_H, tb.TILE_W, bands)
    z = torch.empty((h, w), device=rows.device)
    ids = torch.empty((h, w), dtype=torch.int32, device=rows.device)
    stream = _cuda.stream_of(rows)
    if kind == "vis":
        _cuda.check(lib.sr_binned_vis(
            rows.data_ptr(), rows.shape[1], starts.data_ptr(), nbins, w, h,
            0, tb.TILE_H, bands, gw, z.data_ptr(), ids.data_ptr(), stream))
        return z, ids
    # The previous entry: card_fused's arguments without the bbox, for the
    # lit and textured plan of config 4.
    chans = kw["chans"]
    offs = [-1 if o is None else o for o in (
        _chan_offset(chans, n) for n in ("rgb", "normal", "uv"))]
    n_out = sum(s for _, s in fused_output_channels(
        "textured", chans, True, True))
    out = torch.empty((n_out, h, w), device=rows.device)
    seed_ptrs = (None,) * 3 if kw["seeds"] is None else tuple(
        t.data_ptr() for t in kw["seeds"])
    _cuda.check(lib.sr_fused(
        rows.data_ptr(), starts.data_ptr(), nbins, kw["params"].data_ptr(),
        rows.shape[1], w, h, 0, tb.TILE_H, bands, gw,
        sum(s for _, s in chans), *offs, 1, 1, *seed_ptrs, z.data_ptr(),
        ids.data_ptr(), out.data_ptr(), stream))
    return z, ids, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a csrc/ directory to time beside the sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_binned: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = _cuda.BUILD_DIR / "sweep_binned"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {_name(sh): _variant(sh, out_dir) for sh in SHAPES}
    if args.baseline is not None:
        srcs["baseline"] = args.baseline / "fused.cu"
        srcs["baseline_vis"] = args.baseline / "binned_vis.cu"
    built = _build(srcs, out_dir)
    libs = {name: _load(so, name.startswith("baseline"))
            for name, (so, _) in built.items()}
    order = [n for n in libs if not n.startswith("baseline")]
    turns = order + order[::-1]
    if args.baseline is not None:
        turns = ["baseline"] + turns + ["baseline"]

    res = {"card": card, "reps": REPS, "registers_spills": {
        n: _regs(log) for n, (_, log) in built.items()}, "cases": {}}
    for case, (kind, rows, starts, bbox, kw) in inputs(dev).items():
        pkg = (tb.binned_vis_kernel if kind == "vis" else
               lambda r, s, **k: tb.fused_kernel(r, s, k.pop("params"),
                                                 **k))
        want = pkg(rows, starts, bbox=bbox, **dict(kw))
        times = {n: [] for n in order + (["baseline"] if "baseline" in libs
                                         else [])}
        for name in turns:
            legacy = name.startswith("baseline")
            lib = libs["baseline_vis" if legacy and kind == "vis" else name]
            got = _call(lib, legacy, kind, rows, starts, bbox, kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs on {case}")
            times[name].append(graph_ms(lambda: _call(
                lib, legacy, kind, rows, starts, bbox, kw), REPS))
        res["cases"][case] = dict(pairs=rows.shape[0],
                                  records_per_bin=percentiles(starts),
                                  ms=times)
        print(f"{case}: {rows.shape[0]} pairs, records per bin "
              f"{json.dumps(percentiles(starts))}; ms {json.dumps(times)}",
              flush=True)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
