"""Tile-shape sweep of the record-walking visibility kernel, and its time
against another version of the same sources.

    python -m software_renderer_tpu_torch.tools.sweep_visibility \
        [--baseline DIR]

Builds csrc/visibility_merge.cu once per variant of :data:`SHAPES` (its
tile, super-tile and block-bound constants substituted), each into a
library of its own, all ``nvcc`` processes started together; with
``--baseline``, also ``DIR/visibility_merge.cu`` and
``DIR/probe_gather.cu`` as they are (for example the csrc/ of an earlier
commit). The inputs are the main path's, at config 4's full size (frame
0, 1920x1080): every record as the ``pallas`` backend gives them (K3'),
the kmax=1 overflow set (K3), and config 2's cube at 1920x1080 (K3' on
large triangles); the window lookup (K8) at the gather probe's shapes.
Every library's output must equal the package's kernel bit for bit.

Times: CUDA events over back-to-back calls of the whole wrapper, in turns
(baseline, the variants, the variants again in reverse, baseline), with
each kernel's registers and spills from ``-Xptxas -v``. Prints the card
line and one JSON line. Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..models import scenes
from ..ops import binning as tb
from ..ops import frontend as fe
from ..ops.rasterize_kernel import (_poison_row, card_visibility,
                                    visibility_kernel,
                                    visibility_merge_kernel)
from ..render import triangle_inputs
from . import probe_dyngather as probe

# Variants: the constants of csrc/visibility_merge.cu to substitute
# (kTileW a multiple of 32 dividing 256 threads' warps, the super-tile a
# multiple of the tile, kMinBlocks the resident blocks per SM asked of
# ptxas).
KEYS = ("kTileW", "kTileH", "kSuperW", "kSuperH", "kMinBlocks")
SHAPES = ((32, 32, 256, 128, 2), (32, 32, 256, 128, 3),
          (32, 32, 128, 64, 2), (32, 32, 512, 256, 2),
          (64, 32, 256, 128, 2), (64, 64, 256, 128, 2))
REPS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int


def _build(srcs: dict, out_dir: Path) -> dict:
    """Compile each named source (a path) into ``out_dir/<name>.so``, all
    at once; return {name: (library path, ptxas log)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-I", str(src.parent), "-I", str(_cuda.CSRC), "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (so, log)
    return built


def _variant(shape, out_dir: Path) -> Path:
    """visibility_merge.cu with the constants of ``shape`` (KEYS)
    substituted."""
    src = (_cuda.CSRC / "visibility_merge.cu").read_text()
    for key, val in zip(KEYS, shape):
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{key} not found in visibility_merge.cu")
    path = out_dir / f"visibility_{_name(shape)}.cu"
    path.write_text(src)
    return path


def _name(shape) -> str:
    w, h, sw, sh, b = shape
    return f"{w}x{h}s{sw}x{sh}b{b}"


def _load(so: Path, legacy: bool):
    """A built library. ``legacy``: an earlier csrc/ whose visibility
    entries take the records alone, (rec, n, [z_in, id_in,] width, height,
    y_start, z, id, stream); else this version's entries."""
    lib = ctypes.CDLL(str(so))
    sigs = {k: v for k, v in _cuda._SIGNATURES.items()
            if k.startswith("sr_visibility") or k == "sr_window_lookup"}
    if legacy:
        sigs.update(sr_visibility=(_P, _I, _I, _I, _I, _P, _P, _P),
                    sr_visibility_merge=(_P, _I, _P, _P, _I, _I, _I, _P, _P,
                                         _P))
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
    return lib


def _regs(log: str) -> list:
    """(registers, spill stores) per compiled kernel of a ptxas log."""
    return [(int(r), int(s)) for s, r in zip(
        re.findall(r"(\d+) bytes spill stores", log),
        re.findall(r"Used (\d+) registers", log))]


def _inputs(dev):
    """{case: (records, width, height)} at the main path's shapes."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    ps = triangle_inputs(rp)[0]
    info1 = tb.build_bins(ps, width=w, height=h, kmax=1,
                          pair_budget_factor=0.85, bands=4)
    ov = torch.nonzero(info1.overflow_mask).squeeze(1).to(torch.int32)
    rec_all = fe.pack_records_planar(ps, 128)
    cube = scenes.config2_textured_cube(0.7, width=w, height=h, device=dev)
    return {
        "clear_all_records": (rec_all, w, h),
        "merge_overflow": (tb.gather_stream(rec_all, ov, _poison_row(dev))
                           .contiguous(), w, h),
        "clear_cube_1080p": (fe.pack_records_planar(
            triangle_inputs(cube)[0], 128), w, h),
    }


def _vis_call(lib, legacy, case, rec, w, h, z0, i0):
    """One call of ``lib``'s visibility kernels on a case."""
    seed = (z0, i0) if case.startswith("merge") else (None, None)
    if not legacy:
        return card_visibility(lib, rec, *seed, width=w, height=h)
    z = torch.empty((h, w), device=rec.device)
    ids = torch.empty((h, w), dtype=torch.int32, device=rec.device)
    tail = (w, h, 0, z.data_ptr(), ids.data_ptr(), _cuda.stream_of(rec))
    if seed[0] is None:
        _cuda.check(lib.sr_visibility(rec.data_ptr(), rec.shape[0], *tail))
    else:
        _cuda.check(lib.sr_visibility_merge(
            rec.data_ptr(), rec.shape[0], z0.data_ptr(), i0.data_ptr(),
            *tail))
    return z, ids


def _lookup_call(lib, tab, y0, ty, tx):
    out = torch.empty(ty.shape, device=tab.device)
    _cuda.check(lib.sr_window_lookup(
        tab.data_ptr(), tab.shape[0], tab.shape[1], y0.data_ptr(),
        ty.data_ptr(), tx.data_ptr(), y0.shape[0], out.data_ptr(),
        _cuda.stream_of(tab)))
    return out


def _ms(fn, reps=REPS):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a csrc/ directory to time beside the sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_visibility: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = _cuda.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {_name(sh): _variant(sh, out_dir) for sh in SHAPES}
    if args.baseline is not None:
        srcs["baseline"] = args.baseline / "visibility_merge.cu"
        srcs["baseline_probe"] = args.baseline / "probe_gather.cu"
    built = _build(srcs, out_dir)
    libs = {name: _load(so, name.startswith("baseline"))
            for name, (so, _) in built.items()}
    order = [n for n in libs if n != "baseline_probe"]
    if "baseline" in order:
        order.remove("baseline")
        turns = ["baseline"] + order + order[::-1] + ["baseline"]
    else:
        turns = order + order[::-1]

    cases = _inputs(dev)
    res = {"card": card, "reps": REPS, "registers_spills": {
        n: _regs(log) for n, (_, log) in built.items()}, "cases": {}}
    for case, (rec, w, h) in cases.items():
        z0 = torch.full((h, w), float("inf"), device=dev)
        i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)
        if case.startswith("merge"):
            want = visibility_merge_kernel(rec, z0, i0, width=w, height=h)
        else:
            want = visibility_kernel(rec, width=w, height=h)
        times = {n: [] for n in order + (["baseline"] if "baseline" in libs
                                         else [])}
        for name in turns:
            legacy = name.startswith("baseline")
            got = _vis_call(libs[name], legacy, case, rec, w, h, z0, i0)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} differs on {case}")
            times[name].append(_ms(lambda: _vis_call(
                libs[name], legacy, case, rec, w, h, z0, i0)))
        res["cases"][case] = dict(records=rec.shape[0], ms=times)
        print(f"{case}: {rec.shape[0]} records; ms {json.dumps(times)}",
              flush=True)

    if "baseline_probe" in libs:
        tab, y0, ty, tx, _, _ = probe.lookup_inputs(np.random.default_rng(0),
                                                    dev)
        want = probe.window_lookup(tab, y0, ty, tx)
        times = {"package": [], "baseline": [], "torch_index": []}
        pairs = (("baseline", lambda: _lookup_call(
                    libs["baseline_probe"], tab, y0, ty, tx)),
                 ("package", lambda: probe.window_lookup(tab, y0, ty, tx)),
                 ("torch_index", lambda: probe.window_lookup_plain(
                     tab, y0, ty, tx)))
        for name, fn in pairs + pairs[::-1]:
            if not torch.equal(fn(), want):
                raise AssertionError(f"window lookup {name} differs")
            times[name].append(probe.graph_ms(fn, 50))
        res["window_lookup_graph_ms"] = times
        print(f"window lookup (graph replays): {json.dumps(times)}",
              flush=True)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
