"""The readings that the limits of a cell's check are set from, on the
card at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds 2] [--steps N]
        [--fault spill_plane]

For each seed: the cell's driver, its set-up and a short window of its
own traffic (``--seconds``; texture fitting: exactly ``--steps`` window
steps, as many as a run's window makes), then the numbers its check
compares (the program against the reference), for frames also each
frame's. For each control seed also the control's numbers (the
reference in the precision below the configuration's, in the program's
place) and, for texture fitting, a planted fault (half of the frames
left out of each step, the mean taken over the rest, in the reference
put in the program's place). With ``--fault spill_plane`` every seed
runs the program with a fault confined to the overflow path's pixels:
the first G-buffer plane that K4 writes for the overflow winners is
scaled by 0.9 (depth and ids stay right). Prints one JSON line per
reading.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(Path(__file__).resolve().parent)]

import torch  # noqa: E402

from benchlib import compare, drivers, harness, program  # noqa: E402
from benchlib import reference as ref  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def spilled(drv, items):
    """How many of the compared frames take the program's overflow path
    (its bin build's own count; for this record only, the check never
    reads it)."""
    render = program.module("render")
    binning = program.module("ops.binning")
    n = 0
    for it in items:
        rp = drv.rp(it.transform)
        if rp.clip_near:
            setup = render.clip_inputs(rp)[0]
        else:
            setup = render.planar_front_table_of(rp)[0]
        ps = program.module("ops.frontend").as_planar(setup)
        bands = (binning.FUSED_BANDS
                 if ps.num_triangles >= binning.FUSED_BANDS_MIN_T else 1)
        info = binning.build_bins(ps, width=rp.width, height=rp.height,
                                  kmax=binning.KMAX * bands, bands=bands,
                                  pair_budget_factor=0.85)
        n += int(info.n_overflow) > 0
    return n


def frame_readings(drv, cell, seed, control, out):
    scene = drv.reference_scene()
    items = drv.check_items(scene)
    t0 = time.perf_counter()
    total, per, alt = compare.FrameTally(), [], {}
    for it in items:
        r = ref.render(scene, it.transform, cell.config)
        one = compare.FrameTally()
        cut = ref.cut_pixels(scene, it.transform, r.ids)
        for tally in (total, one):
            tally.add(it.color, it.depth, r.color, r.depth, cut)
        n = one.numbers()
        per.append([round(n["rgb8_off_share"], 6),
                    round(n["rgb8_tile_off8_share"], 6)])
        for k, v in alternatives(it, r, scene).items():
            alt[k] = max(alt.get(k, 0.0), v)
        del r
    out(dict(kind="per_frame", seed=seed, off_and_tile=per,
             labels=[it.label for it in items]))
    out(dict(kind="program", seed=seed, frames=len(items),
             ref_s=time.perf_counter() - t0,
             spilled_frames=spilled(drv, items), **total.numbers(), **alt))
    if control:
        out(dict(kind="control", seed=seed, **compare.control_numbers(
            items, scene, cell.config)))


def alternatives(it, r, scene):
    """Other local measures, for the record: the tile share past 16
    levels, past 8 levels in 32 x 32 tiles, and past 8 levels over every
    covered pixel, cut at the near plane or not; and the largest share of
    a frame's covered pixels whose winner the near plane cuts."""
    p = compare.rgba8(it.color).to(r.color.device)
    q = compare.rgba8(r.color)
    both = (p[..., 3] > 0) & (q[..., 3] > 0)
    d = (p[..., :3].int() - q[..., :3].int()).abs()
    cut = ref.cut_pixels(scene, it.transform, r.ids)
    return {"tile16_off16": compare.tile_share((d > 16).any(-1), both),
            "tile32_off8": compare.tile_share((d > 8).any(-1), both, 32,
                                              256),
            "tile_all_off8": compare.tile_share((d > 8).any(-1), both),
            "cut_px_share": float((both & cut).sum()
                                  / both.sum().clamp(min=1))}


def train_readings(drv, cell, seed, control, out):
    t0 = time.perf_counter()
    ref_losses, ref_states = compare.reference_train(drv)
    out(dict(kind="program", seed=seed, steps=len(drv.losses),
             ref_s=time.perf_counter() - t0, losses=drv.losses,
             ref_losses=ref_losses,
             **compare.program_train_numbers(drv, ref_losses, ref_states)))
    if not control:
        return
    k = drv.first
    cl, cs = compare.reference_train(
        drv, ref.CONTROL[cell.config["precision"]])
    cs = [x.float() for x in cs]
    out(dict(kind="control", seed=seed, **compare.train_numbers(
        cl, cs[:k], cs[-1], drv.tex0, ref_losses, ref_states, drv.lr, k)))
    # Fault: half of the frames left out, the mean taken over the rest.
    hl, hs = compare.reference_train(drv, frames=slice(0, len(drv.ts) // 2))
    out(dict(kind="fault_half_batch", seed=seed, **compare.train_numbers(
        hl, hs[:k], hs[-1], drv.tex0, ref_losses, ref_states, drv.lr, k)))


def plant_spill_fault():
    """Scale the first plane of K4's overflow G-buffer by 0.9, inside
    the program's frame (captured with it)."""
    binning = program.module("ops.binning")
    orig = binning.resolve_merge_kernel

    def faulty(*a, **k):
        gb = orig(*a, **k)
        gb[0].mul_(0.9)
        return gb
    binning.resolve_merge_kernel = faulty


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=0,
                    help="texture fitting: window steps (not --seconds)")
    ap.add_argument("--fault", choices=("spill_plane",), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a small frame and scene, for a rehearsal")
    args = ap.parse_args()
    cell = harness.find_cell(ROOT, args.workload)
    program.select_sampler_route(cell.config["sampler_route"])
    program.enable_build_cache()
    if args.fault == "spill_plane":
        plant_spill_fault()
    if args.small:
        cell.config.update(width=256, height=144)
        cell.config["scene"]["target_triangles"] = 3000
        if cell.traffic["entry"] == "render_batch":
            cell.traffic.update(batch=4, compare_frames=3, keep_within=4)

    def out(d):
        print(json.dumps(dict(cell=args.workload, **d)), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = drivers.load(cell.traffic)(cell.config, cell.traffic, seed,
                                         args.device)
        drv.setup()
        t1 = time.perf_counter()
        if args.steps:
            for _ in range(args.steps):
                drv.step()
        while not args.steps and time.perf_counter() - t1 < args.seconds:
            drv.step()
        control = seed in args.control_seeds
        if cell.traffic["entry"] == "texture_train_step":
            train_readings(drv, cell, seed, control, out)
        else:
            frame_readings(drv, cell, seed, control, out)
        print(f"seed {seed}: set-up {t1 - t0:.2f} s, all "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr,
              flush=True)
        # Free the last seed's graphs and pinned buffers now, not in a
        # garbage collection during the next seed's capture.
        del drv
        gc.collect()
        if args.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
