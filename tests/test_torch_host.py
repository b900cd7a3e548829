"""PyTorch port, the host surface: the teapot generator and config 3's
fallback, image IO, the native runtime, checkpoints, logging, device
info, timing, the frame loop and the live viewer, on the CPU against the
JAX package where it has the same function.

Tolerances: every comparison here is exact. The teapot's arrays, the
PNG and PPM bytes, the OBJ arrays and checkpoint arrays are bit for bit
(both packages run the same numpy, zlib and C++ code); decoded frames
equal ``to_rgba8`` of the port's own render byte for byte.
"""
import json
import logging
import os
import urllib.request

import numpy as np
import pytest
import torch

from software_renderer_tpu import runtime as jruntime
from software_renderer_tpu.models import mesh as jmesh
from software_renderer_tpu.models import teapot as jteapot
from software_renderer_tpu.utils import checkpoint as jckpt
from software_renderer_tpu.utils import image_io as jio
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, runtime
from software_renderer_tpu_torch.models import obj as tobj
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.models import teapot as tteapot
from software_renderer_tpu_torch.utils import checkpoint as tckpt
from software_renderer_tpu_torch.utils import image_io as tio
from software_renderer_tpu_torch.utils import log as tlog
from software_renderer_tpu_torch.utils import profiling
from software_renderer_tpu_torch.utils.config import RenderConfig
from software_renderer_tpu_torch.utils.device import (DeviceInfo, block_on,
                                                      memory_in_use)
from software_renderer_tpu_torch.utils.display import FrameLoop
from software_renderer_tpu_torch.utils.present import PresentServer
from software_renderer_tpu_torch.utils.timing import (BenchResult,
                                                      bench_frame)

torch.set_num_threads(1)


def _image(h=7, w=5, c=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("resolution", [3, 9])
def test_teapot_mesh_equals_jax(resolution):
    got = tteapot.teapot_mesh(resolution)
    want = jteapot.teapot_mesh(resolution)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # 32 patches x resolution^2 quads x 2, less the pole quads welding
    # makes degenerate.
    assert got[1].shape[0] == {3: 552, 9: 5112}[resolution]


def test_config3_falls_back_to_the_generator(monkeypatch, tmp_path):
    """Without assets/teapot.obj, config 3 builds JAX's fallback mesh
    (``teapot_mesh(9)``, abs(normal) colors) and renders."""
    monkeypatch.setattr(tscenes, "TEAPOT_OBJ", tmp_path / "missing.obj")
    rp = tscenes.config3_phong_mesh(0.3, width=64, height=64, device="cpu")
    p, t, n, uv = jteapot.teapot_mesh(9)
    want = jmesh.mesh_from_numpy(p, t.reshape(-1), colors=np.abs(n),
                                 normals=n, uvs=uv)
    for name in ("positions", "indices", "colors", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(rp.mesh, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert rp.mesh.indices.numel() // 3 == 5112
    fb = srt.render(rp)
    assert bool(torch.isfinite(fb.color).all())
    assert float(fb.color[..., 3].mean()) > 0


@pytest.mark.parametrize("c", [1, 3, 4])
def test_encode_png_and_ppm_equal_jax(c, tmp_path):
    img = _image(c=c)[..., 0] if c == 1 else _image(c=c)
    assert tio.encode_png(img) == jio.encode_png(img)
    assert tio.encode_png(torch.from_numpy(img), level=1) == \
        jio.encode_png(img, level=1)
    np.testing.assert_array_equal(
        tio.decode_png(tio.encode_png(img)).reshape(img.shape), img)
    if c != 1:
        tio.write_ppm(str(tmp_path / "t.ppm"), torch.from_numpy(img))
        jio.write_ppm(str(tmp_path / "j.ppm"), img)
        assert (tmp_path / "t.ppm").read_bytes() == \
            (tmp_path / "j.ppm").read_bytes()
    with pytest.raises(ValueError):
        tio.encode_png(img.astype(np.float32))


def test_native_runtime_matches_python_and_jax(tmp_path):
    """The native PNG writer and OBJ reader (built with g++ into the
    build directory) agree with the Python path and, where JAX's runtime
    built too, with JAX's."""
    if not runtime.available():
        pytest.skip("no g++ and zlib to build the native runtime")
    with_jax = jruntime.available()
    assert runtime.library_path().parent == _cuda.BUILD_DIR
    img = _image(h=33, w=17)
    runtime.write_png(str(tmp_path / "t.png"), torch.from_numpy(img))
    if with_jax:
        jruntime.write_png(str(tmp_path / "j.png"), img)
        assert (tmp_path / "t.png").read_bytes() == \
            (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(runtime.read_png(str(tmp_path / "t.png")),
                                  img)
    with pytest.raises(ValueError):  # non-uint8: the Python encoder's rule
        runtime.write_png(str(tmp_path / "f.png"), img.astype(np.float32))
    path = str(tscenes.TEAPOT_OBJ)
    got = runtime.load_obj(path, device="cpu")
    py = tobj.load_obj(path, device="cpu")
    jx = jruntime.load_obj(path) if with_jax else py
    for name in ("positions", "indices", "colors", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(py, name).numpy())
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jx, name)))
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\nv 1 0 0\n")
    with pytest.raises(ValueError, match="no OBJ face data"):
        runtime.load_obj(str(empty), device="cpu")
    with pytest.raises(IOError):
        runtime.load_obj(str(tmp_path / "missing.obj"), device="cpu")


def test_native_build_failure_is_logged_once(monkeypatch, tmp_path, caplog):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SRC", bad)
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_build_error", None)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    logger = tlog.get_logger()
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        assert not runtime.available()
        assert not runtime.available()
        img = _image()
        runtime.write_png(str(tmp_path / "p.png"), img)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "g++ failed" in warnings[0].getMessage()
    assert (tmp_path / "p.png").read_bytes() == jio.encode_png(img)


def test_checkpoints_load_in_either_package(tmp_path):
    tex = torch.rand(4, 3, 3, generator=torch.Generator().manual_seed(1))
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), {"texture": tex},
                          meta={"step": 7})
    arrays, meta = jckpt.load_checkpoint(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(arrays["texture"], tex.numpy())
    assert meta == {"step": 7}
    jckpt.save_checkpoint(str(tmp_path / "j.npz"),
                          {"texture": tex.numpy() * 2}, meta={"step": 3})
    arrays, meta = tckpt.load_checkpoint(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(arrays["texture"], tex.numpy() * 2)
    assert meta == {"step": 3}
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "j.npz.json", "t.npz",
                                            "t.npz.json"]


def test_log_device_and_timing_on_the_cpu():
    assert tlog.get_logger("x").name == "software_renderer_tpu_torch.x"
    info = DeviceInfo.query("cpu")
    assert (info.platform, info.kind, info.memory_bytes) == ("cpu", "cpu",
                                                             None)
    assert memory_in_use("cpu") is None
    x = torch.ones(3)
    assert block_on({"a": [x, (x,)]})["a"][0] is x
    res = bench_frame(lambda v: v * 2.0, lambda i: (torch.full((8,), i),),
                      name="double", triangles=1000, iters=5)
    assert isinstance(res, BenchResult)
    assert res.frames == 5 and res.p50_ms > 0 and res.fps > 0
    assert res.mtri_s > 0 and res.device_ms is None and "double" in str(res)
    with profiling.span("sr.test_stage") as sp:
        y = x + 1
    assert sp is None and torch.equal(y, x + 1)


def _sphere(t):
    return tscenes.reference_sphere(t, width=32, height=32, device="cpu")


@pytest.mark.parametrize("msaa", [1, 2])
def test_frame_loop_writes_the_rendered_frames(tmp_path, msaa):
    """Two frames of the reference sphere at 32x32 through FrameLoop.run:
    the PNGs decode to to_rgba8 of the port's render (render_msaa with
    the msaa knob), frame i at time i * time_step."""
    cfg = RenderConfig(width=32, height=32, msaa=msaa, time_step=0.25)
    loop = FrameLoop(_sphere, transform_fn=lambda t: _sphere(t).transform,
                     config=cfg)
    fps = loop.run(2, out_dir=str(tmp_path))
    assert fps > 0
    assert sorted(os.listdir(tmp_path)) == ["frame_00000.png",
                                            "frame_00001.png"]
    for i in range(2):
        rp = _sphere(0.25 * i)
        fb = srt.render_msaa(rp, samples=msaa) if msaa > 1 else \
            srt.render(rp)
        want = srt.to_rgba8(fb.color).numpy()
        got = runtime.read_png(str(tmp_path / f"frame_{i:05d}.png"))
        np.testing.assert_array_equal(got, want)
    assert loop.time == 0.5


def test_present_server_serves_a_frame():
    rp = _sphere(0.0)
    fb = srt.render(rp)
    with PresentServer(port=0) as srv:
        loop = FrameLoop(_sphere, config=RenderConfig(width=32, height=32))
        loop.run(1, present=srv)
        with urllib.request.urlopen(srv.url + "frame.png", timeout=10) as r:
            png = r.read()
        with urllib.request.urlopen(srv.url + "stats.json",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert b"<html>" in r.read()
    assert stats["frame"] == 0
    np.testing.assert_array_equal(tio.decode_png(png),
                                  srt.to_rgba8(fb.color).numpy())


# ---------------------------------------------------------------------------
# The program's spans (utils/profiling.py)
# ---------------------------------------------------------------------------

_LAYER_ORDER = {False: ["sr.front", "sr.bins", "sr.spill", "sr.raster",
                        "sr.texture_tail"],
                True: ["sr.clip_front", "sr.bins", "sr.spill", "sr.raster",
                       "sr.texture_tail"]}


def _small_pass(clip):
    if clip:
        return tscenes.config4_camera(0.5, width=64, height=48,
                                      triangles=600, device="cpu")
    return tscenes.config2_textured_cube(0.3, width=64, height=64,
                                         device="cpu")


def test_spans_cost_nothing_without_a_profiler(monkeypatch):
    """With no profiler and no capture, no span reaches record_function
    on a render."""
    rp = _small_pass(False)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fb = srt.render(rp)
    assert fb.color.shape == (64, 64, 4)


@pytest.mark.parametrize("clip", [False, True], ids=["planar", "clip"])
def test_layer_spans_partition_render(tmp_path, clip):
    """Under torch.profiler a render holds sr.render and, inside it, the
    layer spans in the main path's order; every host operator of the
    frame lies inside exactly one layer span."""
    rp = _small_pass(clip)
    with profiling.trace(str(tmp_path)):
        srt.render(rp)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.PREFIX)),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in spans[:1]] == ["sr.render"]
    outer = spans[0]

    def inside(e, s):
        return s["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                       <= s["ts"] + s["dur"])

    layers = spans[1:]
    assert all(inside(s, outer) for s in layers)
    names = [s["name"] for s in layers]
    assert list(dict.fromkeys(names)) == _LAYER_ORDER[clip]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(inside(op, outer) for op in ops)
    assert all(sum(inside(op, s) for s in layers) == 1 for op in ops)


def test_frame_loop_opens_the_key_span_inside_its_frame(tmp_path):
    """Under torch.profiler each FrameLoop frame with a transform_fn
    holds one sr.frame_graph.key span, the FrameGraph's host work before
    a launch, ahead of the frame's render; on the CPU the graph renders
    eagerly, so no launch span opens."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    loop = FrameLoop(_sphere, transform_fn=lambda t: _sphere(t).transform,
                     config=RenderConfig(width=32, height=32))
    fg.reset_routes()
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            loop.frame()
    assert fg.routes == {"capture": 0, "replay": 0, "eager": 2}
    with open(tmp_path / profiling.TRACE_FILE) as f:
        spans = sorted((e for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X"
                        and e.get("cat") == "user_annotation"
                        and e["name"].startswith(profiling.PREFIX)),
                       key=lambda e: e["ts"])
    frames = [s for s in spans if s["name"] == "sr.frame_loop.frame"]
    keys = [s for s in spans if s["name"] == "sr.frame_graph.key"]
    renders = [s for s in spans if s["name"] == "sr.render"]
    assert len(frames) == len(keys) == len(renders) == 2
    for frame, key, rend in zip(frames, keys, renders):
        assert frame["ts"] <= key["ts"] and (
            key["ts"] + key["dur"] <= rend["ts"]
            <= rend["ts"] + rend["dur"] <= frame["ts"] + frame["dur"])
    assert not any(s["name"] == "sr.frame_graph.launch" for s in spans)


def test_capture_layer_map_counts_every_operation():
    """The layer map a capture records, with each operator of a CPU
    render standing in for a graph node: every operator in a layer, the
    layers in the main path's order, and nothing when no capture runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    rp = _small_pass(False)
    with Count():
        with profiling.capturing(lambda: Count.n) as layer_map:
            srt.render(rp)
    layers = layer_map.layers
    assert [name for name, _ in layers] == [s[3:] for s in
                                            _LAYER_ORDER[False]]
    assert sum(n for _, n in layers) == Count.n
    assert profiling.encode("sr.frame_graph.replay", layers) == (
        "sr.frame_graph.replay|" + "|".join(f"{k}={n}" for k, n in layers))
    assert profiling._map is None and profiling.span("sr.bins") is \
        profiling.span("sr.raster")
    # A layer span inside another would hand the outer one's nodes on.
    with profiling.capturing(lambda: Count.n), profiling.span("sr.bins"):
        with pytest.raises(RuntimeError, match="inside sr.bins"):
            with profiling.span("sr.raster"):
                pass
