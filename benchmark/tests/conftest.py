"""The benchmark's own tests, on the CPU at small sizes (the port's
plain versions), apart from the repository's tests/:

    python -m pytest -q benchmark/tests

A test that needs the card carries the ``cuda`` marker and skips inside
the test without one."""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH)]

from benchlib import harness  # noqa: E402

# A small frame and scene, and traffic to match, for the CPU.
SMALL = dict(width=256, height=144)
SMALL_TRIANGLES = 3000
SMALL_TRAFFIC = {
    "render_batch": dict(batch=4, compare_frames=4, keep_within=2,
                         stack_frames=1),
    "render": dict(compare_frames=3, keep_within=3, trace_frames=2),
    "frame_loop": dict(compare_frames=2, keep_within=6, trace_frames=2,
                       stack_frames=1, max_frames=64),
    "texture_train_step": dict(trace_steps=1),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips with a reason without "
        "one)")


def small_cell(name):
    """Cell ``name`` of BENCHMARK.json, cut to the CPU's size."""
    cell = harness.find_cell(ROOT, name)
    cell.config.update(SMALL)
    cell.config["scene"]["target_triangles"] = SMALL_TRIANGLES
    cell.traffic.update(SMALL_TRAFFIC[cell.traffic["entry"]])
    return cell


# A seed whose viewer starts at t = 0.46 s, inside the object cloud.
VIEW_SEED = 1234567890134


def run_small(name, seed=None, seconds=0.5, trace=False):
    """One run of a small cell on the CPU: (result, rows)."""
    cell = small_cell(name)
    if seed is None:
        seed = (VIEW_SEED if cell.traffic["entry"] == "frame_loop"
                else 1234567890123)
    return harness.run_cell(ROOT, name, seed, seconds, trace, "cpu",
                            time.time(), log=lambda s: None, cell=cell)


@pytest.fixture
def cells():
    return [w["name"] for w in harness.load_json(
        ROOT / "BENCHMARK.json")["workloads"]]
