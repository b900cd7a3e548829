"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (and the scene, texture and camera it names,
benchlib/inputs.py), the traffic mix's file
(``benchmark/traffic/<traffic>.json``) and the driver of the entry point
it names (``benchmark/entries/<entry>.py``), the limits of its check
(``benchmark/limits/<cell>.json``) and, with ``--trace 1``, one reader
per per-layer metric (``benchmark/metrics/<metric>.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import compare, drivers, inputs, plugins, program
from . import reference as ref
from . import trace as tr

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "software_renderer_tpu")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux
    /proc), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    manifest = load_json(root / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"]
                if c["name"] == cell["config"])

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    config = load_json(root / conf["file"])
    if config.get("name") != conf["name"]:
        raise ValueError(f"{conf['file']} names {config.get('name')!r}, "
                         f"not {conf['name']!r}")
    inputs.validate(config)
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    drivers.load(traffic)
    return Cell(name=name, config=config, traffic=traffic,
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=[m for m in manifest["end_to_end"]
                            if reports(m)],
                per_layer=[m for m in manifest["per_layer"] if reports(m)])


def metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    return plugins.load("metrics", name).read


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the driver (host-clock records and
    the program's counters), the traced stretch of the cell's traffic
    (``trace``), the same frames rendered eagerly with Python stacks
    (``stack``, frame cells with stack metrics) and the reference's
    counts of those frames (``work``)."""

    driver: object
    trace: tr.Trace
    stack: tr.Trace = None
    work: list = None
    config: dict = None


def frame_work(scene, transforms, cfg):
    """The reference's counts per frame: triangles covering some pixel,
    covered pixels and covering (pixel, triangle) pairs."""
    out = []
    for t in transforms:
        g = ref.geometry(scene["positions"], scene["indices"], t,
                         cfg["width"], cfg["height"],
                         clip_near=cfg["clip_near"])
        st = ref.setup(g, cfg["width"], cfg["height"],
                       cull_backfaces=cfg["cull_backfaces"])
        out.append(ref.coverage_counts(st, cfg["width"], cfg["height"]))
    return out


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, log=print,
             cell: Cell | None = None):
    """One run of a cell on ``device``: returns the result dict (the
    checks last) and the rows of the check."""
    cell = cell or find_cell(root, name)
    device = torch.device(device)
    cls = drivers.load(cell.traffic)
    route = program.select_sampler_route(cell.config["sampler_route"])
    log(f"cell {name}: seed {seed}, {seconds} s, trace {int(trace)}; "
        f"sampler route {program.ROUTE_VAR}={route!r} (configuration: "
        f"{cell.config['sampler_route']!r}); traffic: "
        f"{cell.traffic.get('why', cell.traffic['entry'])}")
    drv = cls(cell.config, cell.traffic, seed, device)
    gc.collect()     # no collection of stray CUDA objects during a capture
    drv.setup()
    drivers.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    routes = getattr(drv, "routes", None)
    if routes is not None:
        for k in routes:
            routes[k] = 0
    t_window = time.perf_counter()
    # Set-up leaves out the reference's own work in it.
    setup_s = time.time() - t_start - drv.ref_s
    while True:
        drv.step()
        window_s = time.perf_counter() - t_window
        if window_s >= seconds:
            break
    drv.window_routes = dict(routes) if routes is not None else {}
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    log(f"window: {window_s:.3f} s, {drv.attempted} calls, "
        f"{drv.items_done} items, set-up {setup_s:.3f} s (the reference's "
        f"{drv.ref_s:.3f} s in it left out)")

    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if not trace:
        e2e = drv.metrics(window_s)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = traced(drv, cell, log)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = ctx.trace.busy_s()
        dev_info["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": ctx.trace.top_ops(10),
                     "idle_gaps": ctx.trace.idle_gaps(10)}

    numbers, rows, ok = check(drv, cell, log)
    result = {"correct": ok, "attempted": drv.attempted,
              "failed": 0 if ok else drv.attempted,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim, _ in rows}
    return result, rows


def traced(drv, cell, log):
    """The traced stretch after the window: the cell's own traffic
    under the profiler, and for frame cells with stack metrics the
    same frames rendered eagerly with Python stacks."""
    tr.profile(lambda: None, 0)           # the profiler's first start
    fn, items = drv.trace_fn()
    fn()                                   # the stretch's own warm-up
    trace = tr.profile(fn, items)
    log(f"traced {items} items: {trace.launches()} device operations, "
        f"busy {trace.busy_s():.6f} of {trace.window_s:.6f} s")
    ctx = Context(driver=drv, trace=trace, config=cell.config)
    if hasattr(drv, "stack_fn") and cell.traffic.get("stack_frames"):
        sfn, k, ts = drv.stack_fn()
        sfn()
        ctx.stack = tr.profile(sfn, k, with_stack=True)
        log(f"stack trace of {k} eager frames: "
            f"{ctx.stack.launches()} device operations, Python stacks "
            f"{'present' if ctx.stack.has_stacks() else 'absent'}")
        ctx.work = frame_work(drv.reference_scene(), ts, cell.config)
    return ctx


def check(drv, cell, log):
    """The comparison after the window: the numbers, each beside its
    limit, and whether all hold."""
    t0 = time.perf_counter()
    numbers, complete = drv.compared(log)
    ok, rows = compare.judge(numbers, cell.limits)
    log(f"compared numbers: {json.dumps(numbers)}")
    log(f"check took {time.perf_counter() - t0:.3f} s")
    return numbers, rows, ok and complete


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH_DIR.parent
    log = lambda s: print(s, file=sys.stderr, flush=True)
    if not (root / "BENCHMARK.json").exists():
        log("no BENCHMARK.json beside the benchmark")
        return 2
    cell = find_cell(root, args.workload)
    manifest = load_json(root / "BENCHMARK.json")
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        # The route is read when the program is imported.
        program.select_sampler_route(cell.config["sampler_route"])
        program.package()
    except ImportError as e:
        log(f"the program does not import: {e}")
        return 4
    program.enable_build_cache()
    log(f"card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    result, rows = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_start, log, cell)
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules the benchmark must not load: {bad}")
        return 5
    for k, v, lim, ok in rows:
        log(f"check {k}: {v} (limit {lim}) {'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
