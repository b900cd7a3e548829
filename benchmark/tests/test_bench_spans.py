"""The readers of the program's spans (benchlib/spans.py and the
``program_span`` metrics) on a small hand-written Chrome trace: one
replayed frame whose graph launch runs three kernels and a memset, cut
by the layer map in its span's name, and a capture span with the device
idle inside it. Times in microseconds, as the trace has them."""

import copy
import json
import types

import pytest

from conftest import ROOT
from benchlib import plugins, spans
from benchlib import trace as tr

REPLAY = "sr.frame_graph.replay|front=1|bins=2|texture_tail=1"


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(replay=REPLAY):
    return {"traceEvents": [
        _x("Trace", "PyTorch Profiler (0)", 0, 1000, tid="PyTorch Profiler"),
        # The transform's copy, then the replay's graph launch.
        _x("user_annotation", replay, 90, 60),
        _x("cpu_op", "aten::copy_", 100, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 105, 3, corr=5),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 120, 2, tid=7,
           corr=5),
        _x("cuda_runtime", "cudaGraphLaunch", 130, 10, corr=7),
        _x("kernel", "fe_table_kernel", 200, 10, tid=7, corr=7),
        _x("gpu_memset", "Memset (Device)", 215, 5, tid=7, corr=7),
        _x("kernel", "sort_kernel", 225, 20, tid=7, corr=7),
        _x("kernel", "gather_kernel", 250, 40, tid=7, corr=7),
        # A capture: an eager kernel, then the device idle.
        _x("user_annotation", "sr.frame_graph.capture", 300, 400),
        _x("cpu_op", "aten::add", 305, 8),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 4, corr=9),
        _x("kernel", "add_kernel", 320, 30, tid=7, corr=9),
        _x("cuda_runtime", "cudaLaunchKernel", 750, 4, corr=11),
        _x("kernel", "walk_kernel<true, 0>", 800, 50, tid=7, corr=11),
    ]}


def _ctx(data, items=2):
    ctx = types.SimpleNamespace(driver=None, trace=tr.Trace(data, items))
    ctx.__dict__["_program_spans"] = spans.Spans(data, items)
    return ctx


def test_replay_is_cut_by_its_layer_map():
    s = spans.Spans(_trace(), 1)
    assert s.replay_layers() == [{"front": 0.010, "bins": 0.025,
                                  "texture_tail": 0.040}]
    assert s.replay_ms("bins") == pytest.approx(0.025)
    assert s.replay_ms("clip_front") == 0.0
    read = lambda m: plugins.load("metrics", m).read(_ctx(_trace(), 1))
    assert read("front_replay_ms.frames") == pytest.approx(0.010)
    assert read("bins_replay_ms.frames") == pytest.approx(0.025)
    assert read("texture_tail_replay_ms.frames") == pytest.approx(0.040)


@pytest.mark.parametrize("replay", [
    "sr.frame_graph.replay|front=1|bins=2|texture_tail=2",
    "sr.frame_graph.replay|front=1|bins=1|texture_tail=1"])
def test_a_map_that_does_not_add_up_reads_nothing(replay):
    s = spans.Spans(_trace(replay), 1)
    assert s.replay_layers() == [None]
    assert s.replay_ms("front") is None
    assert plugins.load("metrics", "front_replay_ms.frames").read(
        _ctx(_trace(replay), 1)) is None


def test_device_idle_and_host_inside_a_span():
    """Inside the capture (300-700): the eager kernel (30) launched at
    310; idle gaps 290-320 and 350-800 have their middles inside (480);
    the span's host time 400. Per frame over 2 frames."""
    s = spans.Spans(_trace(), 2)
    dev, idle, host = s.inside("sr.frame_graph.capture")
    assert (dev, idle, host) == pytest.approx((0.030, 0.480, 0.400))
    assert s.inside("sr.frame_loop.frame") is None
    ctx = _ctx(_trace(), 2)
    assert plugins.load("metrics", "capture_idle_ms.frames").read(ctx) == \
        pytest.approx(0.240)
    # The replay span holds the copy (2) launched at 105 and no graph
    # kernel (launched at 130 but run later: launched inside, counted).
    dev, idle, host = s.inside(REPLAY)
    assert dev == pytest.approx((2 + 10 + 5 + 20 + 40) / 1e3)
    assert host == pytest.approx(0.060)


def test_readers_read_nothing_without_the_programs_spans():
    data = _trace()
    data["traceEvents"] = [e for e in data["traceEvents"]
                           if e["cat"] != "user_annotation"]
    for name in ("front_replay_ms.frames", "bins_replay_ms.frames",
                 "texture_tail_replay_ms.frames", "capture_idle_ms.frames",
                 "clip_front_replay_ms.view", "copy_out_ms.view",
                 "frame_idle_ms.view", "bins_host_ms.call",
                 "texture_tail_host_ms.call"):
        read = plugins.load("metrics", name).read
        assert read(_ctx(data)) is None, name
        none = types.SimpleNamespace(driver=None, _program_spans=None)
        assert read(none) is None, name


def test_existing_readers_ignore_the_programs_spans():
    """Every reading of benchlib/trace.py and every reader of the traced
    stretch is byte for byte the same with and without the program's
    user_annotation events."""
    with_spans = _trace()
    without = copy.deepcopy(with_spans)
    without["traceEvents"] = [e for e in without["traceEvents"]
                              if e["cat"] != "user_annotation"]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = [m["name"] for m in manifest["per_layer"]
               if m["source"] != "program_span"]

    def readings(data):
        t = tr.Trace(data, 2)
        out = [t.window_s, t.busy_s(), t.launches(), t.top_ops(),
               t.idle_gaps(), t.device_ms(), t.device_ms("kernel"),
               t.under_cpu_op("aten::"), t.has_stacks()]
        ctx = types.SimpleNamespace(
            trace=t, stack=None, work=None, config=None,
            driver=types.SimpleNamespace(items_done=0, host_s=[],
                                         window_routes={}))
        out += [plugins.load("metrics", m).read(ctx) for m in readers]
        return json.dumps(out)

    assert readings(with_spans) == readings(without)
