"""Grid-shape sweep of the overflow G-buffer resolve (K4), and its time
against another version of the same source.

    python -m software_renderer_tpu_torch.tools.sweep_resolve_merge \
        [--baseline DIR]

Builds csrc/resolve_merge.cu once per variant of :data:`SHAPES` (threads
a block, blocks an SM, resident blocks asked of ptxas, pixels a lane
scans a step), each into a library of its own, all ``nvcc`` processes
started together; with ``--baseline``, also ``DIR/resolve_merge.cu`` as
it is (an earlier commit's csrc/, whose entry takes no slot map and no
SM count, and binary-searches the rows' ids). The inputs are
chip_smoke.py's phase-3 ones at config 4's full size (frame 0,
1920x1080): the kmax=1 overflow set over the static list with its
device count and slot map, with no seed, at a count of 0 and with a zero
seed (cloned, then written in place; the baseline copies it); two parts
of that spill, ids that win nothing and the winners at one channel; and
binned_pipeline's planes of frame 0 with kmax=1 (binned and spilled
winners) written in place (the baseline copies them). Every library's
output must equal the package's kernel bit for bit (with no seed, on
the live winners' pixels of an output filled with NaN first).

Times: CUDA-graph replays (``probe_dyngather.graph_ms``), in turns
(baseline, the variants, the variants again in reverse, baseline), with
the registers and spills of each library's 8-channel kernel from
``-Xptxas -v``. Prints the card line and one JSON line. Runs on the card
only.
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
from ..ops.rasterize_kernel import visibility_merge_kernel
from ..render import triangle_inputs
from .probe_dyngather import graph_ms
from .sweep_visibility import _build, _regs

KEYS = ("kThreads", "kBlocksPerSm", "kMinBlocks", "kGroup")
SHAPES = ((256, 4, 4, 4), (256, 3, 3, 4), (256, 2, 2, 4), (128, 8, 8, 4),
          (384, 3, 3, 4), (192, 5, 5, 4), (512, 4, 4, 4), (256, 8, 8, 4),
          (256, 4, 4, 2), (256, 8, 8, 1))
REPS = 50
BUDGET = 0.85
_P, _I = ctypes.c_void_p, ctypes.c_int


def _variant(shape, out_dir: Path) -> Path:
    """resolve_merge.cu with the constants of ``shape`` (KEYS)
    substituted."""
    src = (_cuda.CSRC / "resolve_merge.cu").read_text()
    for key, val in zip(KEYS, shape):
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{key} not found in resolve_merge.cu")
    path = out_dir / f"resolve_merge_{_name(shape)}.cu"
    path.write_text(src)
    return path


def _name(shape) -> str:
    return "t{}b{}m{}g{}".format(*shape)


def _regs_at(log: str, channels: int = 8) -> list:
    """(registers, spill stores) of the instance for ``channels`` (the
    whole log where the kernel is not a template)."""
    parts = log.split("Compiling entry function")
    mine = [p for p in parts if f"ILi{channels}E" in p.split("\n")[0]]
    return _regs("".join(mine) if mine else log)


def _load(so: Path, legacy: bool):
    """A built library; ``legacy``: the entry without slots and SM count."""
    lib = ctypes.CDLL(str(so))
    lib.sr_resolve_merge.argtypes = (
        (_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P) if legacy
        else _cuda._SIGNATURES["sr_resolve_merge"])
    lib.sr_resolve_merge.restype = _I
    return lib


def _inputs(dev) -> dict:
    """{case: (rows, tid, seed or None, count, slots, channels
    written)}."""
    rp = scenes.config4_many_objects(0.0, device=dev)
    w, h = rp.width, rp.height
    ps, _, attrs, _, _, _ = triangle_inputs(rp)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    bbox = fe.bbox_table(ps)
    z0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), -1, dtype=torch.int32, device=dev)

    def overflow(info, z, i):
        ov, slots = tb.overflow_ids(info.overflow_mask)
        rows = tb.gather_stream(table, ov, poison).contiguous()
        _, tid = visibility_merge_kernel(tb.raster_records(rows, bbox, ov),
                                         z, i, n_live=info.n_overflow,
                                         width=w, height=h)
        return rows, tid, slots

    info1 = tb.build_bins(ps, width=w, height=h, kmax=1,
                          pair_budget_factor=BUDGET, bands=4)
    rows1, tid1, slots1 = overflow(info1, z0, i0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info_b = tb.build_bins(ps, width=w, height=h, kmax=1,
                           pair_budget_factor=BUDGET)
    rows_b = tb.gather_stream(table, info_b.ids, poison).contiguous()
    zb, ib = tb.binned_vis_kernel(rows_b, info_b.bin_start, bbox=bbox,
                                  width=w, height=h)
    rows_o, tid_b, slots_b = overflow(info_b, zb, ib)
    g6 = tb.resolve_kernel(rows_b, info_b.bin_start, tid_b, n_channels=a,
                           width=w, height=h)
    return {
        "spill": (rows1, tid1, None, info1.n_overflow, slots1, a),
        "count0": (rows1, tid1, None, zero, slots1, a),
        # Parts of the spill's time: the scan of ids that win nothing, and
        # the winners at one channel.
        "scan_only": (rows1, i0, None, info1.n_overflow, slots1, a),
        "spill_one_channel": (rows1, tid1, None, info1.n_overflow, slots1,
                              1),
        "spill_seed": (rows1, tid1, torch.zeros((a, h, w), device=dev),
                       info1.n_overflow, slots1, a),
        "binned_inplace": (rows_o, tid_b, g6, info_b.n_overflow, slots_b,
                           a),
    }


def _call(lib, legacy, rows, tid, seed, count, slots, out):
    """One launch of ``lib``'s K4 into ``out`` (the legacy entry copies
    ``seed`` into it; the others write the winners only, into a fresh
    output or a seed)."""
    h, w = tid.shape
    a = out.shape[0]
    if legacy:
        args = (rows.data_ptr(), rows.shape[0], count.data_ptr(),
                rows.shape[1], a, tid.data_ptr(),
                None if seed is None else seed.data_ptr(), w, h, 0,
                out.data_ptr(), _cuda.stream_of(rows))
    else:
        args = (rows.data_ptr(), rows.shape[0], count.data_ptr(),
                rows.shape[1], a, tid.data_ptr(), slots.data_ptr(),
                slots.numel(), w, h, 0, out.data_ptr(),
                _cuda.sm_count(rows.device), _cuda.stream_of(rows))
    _cuda.check(lib.sr_resolve_merge(*args))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a csrc/ directory to time beside the sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_resolve_merge: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = _cuda.BUILD_DIR / "sweep_k4"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {_name(sh): _variant(sh, out_dir) for sh in SHAPES}
    if args.baseline is not None:
        srcs["baseline"] = args.baseline / "resolve_merge.cu"
    built = _build(srcs, out_dir)
    libs = {name: _load(so, name == "baseline")
            for name, (so, _) in built.items()}
    order = [n for n in libs if n != "baseline"]
    turns = order + order[::-1]
    if "baseline" in libs:
        turns = ["baseline"] + turns + ["baseline"]

    res = {"card": card, "reps": REPS, "registers_spills": {
        n: _regs_at(log) for n, (_, log) in built.items()}, "cases": {}}
    for case, (rows, tid, seed, count, slots, a) in _inputs(dev).items():
        want = tb.resolve_merge_kernel(
            rows, tid, seed, width=tid.shape[1], height=tid.shape[0],
            n_live=count, slots=slots)[:a]
        q = tid.long()
        won = (q >= 0) & (slots[q.clamp(min=0)] < count)
        times = {n: [] for n in libs}
        for name in turns:
            legacy = name == "baseline"
            out = (seed.clone() if seed is not None and not legacy
                   else torch.full_like(want, float("nan")))
            call = (lambda lib=libs[name], leg=legacy, o=out: _call(
                lib, leg, rows, tid, seed, count, slots, o))
            got = call()
            torch.cuda.synchronize()
            ok = (torch.equal(got, want) if seed is not None
                  else torch.equal(got[:, won], want[:, won])
                  and bool(got[:, ~won].isnan().all()))
            if not ok:
                raise AssertionError(f"{name} differs on {case}")
            times[name].append(graph_ms(call, REPS))
        res["cases"][case] = dict(rows=int(count), won=int(won.sum()),
                                  ms=times)
        print(f"{case}: count {int(count)}, {int(won.sum())} winner "
              f"pixels; ms {json.dumps(times)}", flush=True)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
