"""PyTorch port, the other backends: ``reference``, ``pallas`` and the
attribute-free ``binned`` path, against the JAX package.

Both packages rasterize one shared front-end (the JAX planar front-end's
columns and its TriangleSetup, carried across with convert's
planar_setup_from_numpy and triangle_setup_from_numpy), so coverage is
identical by construction: ids are compared exactly, depth within the
FMA-contraction class (XLA:CPU may contract the depth plane's
multiply-adds; torch rounds each operation), G-buffers at atol 1e-4 (the
same contraction ulps through the attribute planes, as
tests/test_binning.py uses) and colors with the typed depth-tie class
(testing/compare.py) at atol 1e-3. The JAX side is always its XLA
reference: no Pallas kernel runs in interpret mode here. The plain
versions of the kernels run, since every tensor lies on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.ops import binning as jbin
from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops import texture as jtex
from software_renderer_tpu.ops.rasterize_ref import (
    visibility_ref as jvisibility_ref)
from software_renderer_tpu.ops.resolve import (
    barycentrics_at_pixels as jbarycentrics, interpolate_attribute as jinterp)
from software_renderer_tpu.testing.compare import assert_tie_class_equal
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.models.obj import load_obj
from software_renderer_tpu_torch.ops import binning as tbin
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    pack_records, visibility_kernel, visibility_pallas, visibility_plain)
from software_renderer_tpu_torch.ops.rasterize_ref import visibility_ref
from software_renderer_tpu_torch.ops.resolve import (barycentrics_at_pixels,
                                                     interpolate_attribute)
from software_renderer_tpu_torch.parallel.sharding import make_mesh
from software_renderer_tpu_torch.render import planar_front_of
from software_renderer_tpu_torch.utils.device import DeviceInfo

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _setups(rp):
    """(JAX TriangleSetup, the same setup in torch, the JAX planar
    front-end's columns in torch) through the JAX planar front-end."""
    tris = rp.mesh.triangles()
    ps_j = jfe.planar_front(jfe.corner_cols(rp.mesh.positions[tris]),
                            rp.transform, rp.width, rp.height,
                            cull_backfaces=rp.cull_backfaces, pallas=False)
    s_j = jfe.to_setup(ps_j)
    return (s_j, convert.triangle_setup_from_numpy(s_j, **CPU),
            convert.planar_setup_from_numpy(ps_j, **CPU))


def _port_setup():
    """A small TriangleSetup from the port's own front-end (CPU), for
    tests of the port alone."""
    return tfe.to_setup(planar_front_of(tscenes.config1_flat_cube(
        0.3, width=32, height=32, **CPU)))


def _assert_depth_class(depth_j, depth_t, ids, setup):
    """Depth of the same winner, equal up to the FMA-contraction class:
    4 ulps of the plane chain ``zx * x + zy * y + zc`` at the pixel."""
    depth_t = depth_t.numpy()
    np.testing.assert_array_equal(np.isfinite(depth_j), np.isfinite(depth_t))
    cov = ids.numpy() >= 0
    zp = setup.zplane.numpy()[ids.numpy()[cov]]
    yy, xx = np.nonzero(cov)
    mag = (np.abs(zp[:, 0] * (xx + 0.5)) + np.abs(zp[:, 1] * (yy + 0.5))
           + np.abs(zp[:, 2]))
    err = np.abs(depth_j[cov].astype(np.float64) - depth_t[cov])
    assert (err <= 2.0 ** -21 * mag).all(), (err.max(), int((err > 0).sum()))


@pytest.fixture(scope="module")
def c4():
    """config4 at 320x192 with ~3000 triangles: the JAX reference's and
    the port's reference visibility on one shared setup, and config 4's
    attribute channels as [T, 3, A] values (and as the port's per-corner
    columns)."""
    rp = jscenes.config4_many_objects(0.0, width=320, height=192,
                                      triangles=3000)
    s_j, s_t, ps_t = _setups(rp)
    dj, ij = jvisibility_ref(s_j, width=rp.width, height=rp.height)
    dt, it = visibility_ref(s_t, width=rp.width, height=rp.height)
    m = rp.mesh
    attrs_j, _ = jsh.gather_attribute_values(
        "textured", m.triangles(), colors=m.colors, normals=m.normals,
        uvs=m.uvs)
    attrs_t = torch.from_numpy(np.array(attrs_j))
    # The JAX barycentric resolve of the reference winners, shared by the
    # resolve comparisons below.
    ws_j, cov_j = jbarycentrics(s_j, ij)
    out = dict(rp=rp, s_j=s_j, s_t=s_t, ps_t=ps_t, dj=np.asarray(dj),
               ij=np.asarray(ij), dt=dt, it=it, attrs_j=attrs_j,
               attrs_t=attrs_t, cols_t=tfe.attr_corner_cols(attrs_t),
               ws_j=np.asarray(ws_j),
               gj=np.asarray(jinterp(attrs_j, ij, ws_j, cov_j)))
    out["free"] = _binned(out)   # the spill-free binned frame
    return out


def test_visibility_ref_matches_jax(c4):
    assert 2048 <= c4["s_t"].num_triangles < 4096
    assert bool((c4["it"] >= 0).any())
    np.testing.assert_array_equal(c4["ij"], c4["it"].numpy())
    _assert_depth_class(c4["dj"], c4["dt"], c4["it"], c4["s_t"])


def test_visibility_pallas_plain_equals_reference(c4):
    """The clear mode's plain version (the lex merge from the clear
    buffer) equals the strict first-drawn-wins reference bit for bit."""
    rp = c4["rp"]
    _cuda.reset_launches()
    dp, ip = visibility_pallas(c4["s_t"], width=rp.width, height=rp.height)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    np.testing.assert_array_equal(ip.numpy(), c4["it"].numpy())
    np.testing.assert_array_equal(dp.numpy(), c4["dt"].numpy())
    np.testing.assert_array_equal(ip.numpy(), c4["ij"])


def _binned(c4, **kw):
    rp = c4["rp"]
    return tbin.binned_pipeline(c4["ps_t"], c4["cols_t"], width=rp.width,
                                height=rp.height, chunk=128, **kw)


@pytest.mark.parametrize("spill", ["kmax1", "budget0.1"])
def test_binned_pipeline_matches_jax_reference(c4, spill):
    """binned_pipeline with attributes on frames that spill (so the
    overflow merge and resolve merge run) against the JAX reference
    visibility and barycentric resolve, and against its own spill-free
    frame bit for bit."""
    rp = c4["rp"]
    kw = dict(kmax=1) if spill == "kmax1" else dict(pair_budget_factor=0.1)
    info = tbin.build_bins(c4["ps_t"], width=rp.width, height=rp.height,
                           **kw)
    assert int(info.n_overflow) > 0, "nothing spilled: vacuous"
    d0, i0, g0 = c4["free"]
    d1, i1, g1 = _binned(c4, **kw)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    np.testing.assert_array_equal(g0.numpy(), g1.numpy())
    np.testing.assert_array_equal(c4["ij"], i1.numpy())
    _assert_depth_class(c4["dj"], d1, i1, c4["s_t"])
    gj = c4["gj"]
    assert g1.shape == gj.shape
    np.testing.assert_allclose(gj, g1.numpy(), atol=1e-4)


def test_resolve_equals_barycentric_interpolation(c4):
    """The port's own two resolves agree: planes at the pixel (binned
    path) and barycentric weights times corner values (shade)."""
    rp = c4["rp"]
    ws, cov = barycentrics_at_pixels(c4["s_t"], c4["it"])
    g_bary = interpolate_attribute(c4["attrs_t"], c4["it"], ws, cov)
    np.testing.assert_allclose(c4["ws_j"][c4["ij"] >= 0],
                               ws.numpy()[cov.numpy()], atol=1e-6)
    _, _, g_planes = c4["free"]
    np.testing.assert_allclose(g_bary.numpy(), g_planes.numpy(), atol=1e-4)
    assert bool(cov.any()) and g_bary.shape == (rp.height, rp.width, 8)


def test_stream_table_matches_jax(c4):
    """The port's stream table and raster records of the planar setup
    equal the JAX package's of the array setup: raster columns and
    records bit for bit, attribute planes to float32 rounding."""
    t_p, a_p, poison = tfe.stream_table_planar(
        c4["ps_t"], tfe.attribute_plane_cols(c4["ps_t"], c4["cols_t"]))
    tj, a_j, pj = jbin.build_stream_table(c4["s_j"], c4["attrs_j"])
    tj = np.asarray(tj)
    assert a_p == a_j == 8
    np.testing.assert_array_equal(tj[:, :11], t_p[:, :11].numpy())
    np.testing.assert_allclose(tj[:, 11:], t_p[:, 11:].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(pj), poison.numpy())
    rec = np.asarray(jbin.pack_records(c4["s_j"], 128))
    np.testing.assert_array_equal(rec, pack_records(c4["s_t"], 128).numpy())
    np.testing.assert_array_equal(
        rec, tfe.pack_records_planar(c4["ps_t"], 128).numpy())


def _jax_scene(name):
    if name == "config1":
        return jscenes.config1_flat_cube(0.3, width=96, height=96)
    rp = jscenes.config2_textured_cube(0.7, width=128, height=96)
    if name == "config2_flat":
        return dataclasses.replace(rp, shading="flat")
    if name == "config2_plain_phong":   # phong, no colors, no light
        return dataclasses.replace(
            rp, shading="phong", light=None,
            mesh=dataclasses.replace(rp.mesh, colors=None))
    return rp


@pytest.fixture(scope="module")
def jax_frames():
    return {}


@pytest.mark.parametrize("name,backend", [
    ("config1", "reference"), ("config1", "pallas"), ("config1", "binned"),
    ("config2", "reference"), ("config2", "pallas"), ("config2", "binned"),
    ("config2_flat", "auto"), ("config2_flat", "pallas"),
    ("config2_plain_phong", "auto")])
def test_render_backend_matches_jax_reference(jax_frames, name, backend):
    rp = _jax_scene(name)
    if name not in jax_frames:
        fb = sr.render(rp, backend="reference")
        jax_frames[name] = (np.asarray(fb.color), np.asarray(fb.depth))
    cj, dj = jax_frames[name]
    _cuda.reset_launches()
    fb_t = srt.render(convert.render_pass_from_numpy(
        convert.arrays_of(rp), **CPU, **convert.static_fields_of(rp)),
        backend=backend)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    ct, dt = fb_t.color.numpy(), fb_t.depth.numpy()
    assert ct.shape == cj.shape and dt.shape == dj.shape
    assert ct[..., 3].any(), "nothing covered: vacuous"
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt, atol=1e-3,
                           context=f"{name} {backend}")


def test_new_kernel_wrappers_run_plain_on_cpu():
    """K3', K5 and K6's wrappers take their plain versions on CPU tensors
    and launch nothing."""
    rp = tscenes.config2_textured_cube(0.7, width=128, height=96, **CPU)
    ps = planar_front_of(rp)
    w, h = rp.width, rp.height
    vals = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(ps.num_triangles, 3, 2)).astype(np.float32))
    info = tbin.build_bins(ps, width=w, height=h)
    table, a, poison = tfe.stream_table_planar(
        ps, tfe.attribute_plane_cols(ps, tfe.attr_corner_cols(vals)))
    rows = tbin.gather_stream(table, info.ids, poison).contiguous()
    rec = tfe.pack_records_planar(ps, 128)
    _cuda.reset_launches()
    zk, ik = visibility_kernel(rec, width=w, height=h)
    bbox = tfe.bbox_table(ps)
    zb, ib = tbin.binned_vis_kernel(rows, info.bin_start, bbox=bbox, width=w,
                                    height=h)
    gk = tbin.resolve_kernel(rows, info.bin_start, ib, n_channels=a,
                             width=w, height=h)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    zp, ip = visibility_plain(rec, width=w, height=h)
    assert torch.equal(zk, zp) and torch.equal(ik, ip)
    assert bool((ik >= 0).any())
    zbp, ibp = tbin.binned_vis_plain(rows, info.bin_start, bbox=bbox,
                                     width=w, height=h)
    assert torch.equal(zb, zbp) and torch.equal(ib, ibp)
    assert torch.equal(gk, tbin.resolve_plain(
        rows, info.bin_start, ib, n_channels=a, width=w, height=h))
    # Safe triangles only: the binned frame equals the record walk.
    if int(info.n_overflow) == 0:
        assert torch.equal(ib, ik) and torch.equal(zb, zk)


def _teapot_fallback_scene():
    """Config 3 built from the teapot generator (no OBJ asset)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscenes, "TEAPOT_OBJ", tscenes.TEAPOT_OBJ.with_name(
            "missing.obj"))
        return tscenes.config3_phong_mesh(0.3, width=64, height=64)


@pytest.mark.parametrize("build", [
    lambda: tscenes.config1_flat_cube(0.3, width=64, height=64),
    lambda: tscenes.config4_many_objects(0.0, width=64, height=64,
                                         triangles=600),
    lambda: load_obj(str(tscenes.TEAPOT_OBJ)),
    lambda: convert.render_pass_from_numpy(
        convert.arrays_of(jscenes.config1_flat_cube(0.3, 64, 64))),
    lambda: convert.triangle_setup_from_numpy(_port_setup()),
    lambda: srt.mesh_from_numpy(np.zeros((3, 3)), np.arange(3)),
    lambda: srt.shapes.box(),
    lambda: srt.checkerboard(8, 2),
    lambda: srt.Light.default(),
    lambda: srt.transforms.reference_projection(),
    lambda: srt.transforms.translation_matrix((0.0, 0.0, 1.0)),
    lambda: srt.transforms.scale_matrix(2.0),
    lambda: srt.transforms.trs_matrix(),
    lambda: srt.transforms.reference_demo_transform(0.3),
    lambda: srt.transforms.identity(),
    lambda: srt.transforms.perspective(1.0, 16 / 9, 0.05, 10.0),
    lambda: srt.transforms.look_at((0.0, 0.0, 0.6), (0.0, 0.0, 1.6)),
    lambda: tsh.shading_params(None),
    lambda: srt.create_framebuffer(8, 4),
    lambda: srt.shapes.plane(),
    lambda: tscenes.rotating_triangle(0.3),
    lambda: tscenes.wireframe_cube(0.3),
    lambda: tscenes.intersecting_triangles(0.3),
    lambda: srt.RenderConfig().projection_matrix(),
    lambda: srt.RenderConfig(projection="perspective").projection_matrix(),
    lambda: make_mesh(1, 1),
    lambda: DeviceInfo.query(),
    lambda: _teapot_fallback_scene()],
    ids=["scene", "config4", "load_obj", "render_pass", "setup",
         "mesh_from_numpy", "shape", "checkerboard", "light",
         "reference_projection", "translation_matrix", "scale_matrix",
         "trs_matrix", "reference_demo_transform", "identity",
         "perspective", "look_at", "shading_params", "create_framebuffer",
         "plane", "rotating_triangle", "wireframe_cube",
         "intersecting_triangles", "config_projection",
         "config_perspective", "make_mesh", "device_info",
         "teapot_fallback"])
def test_scenes_default_to_the_card(monkeypatch, build):
    """With no card, a scene (config 3 from the teapot generator too),
    mesh, texture, light, OBJ or convert function, a transform
    constructor whose arguments hold no tensor, the default device mesh
    or the default device's info, given no device raises and names the
    way to ask for the CPU; nothing falls back quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()


@pytest.mark.parametrize("filt,wrap", [("nearest", "repeat"),
                                       ("nearest", "clamp"),
                                       ("bilinear", "repeat"),
                                       ("bilinear", "clamp")])
def test_sample_texture_matches_jax(filt, wrap):
    rng = np.random.default_rng(5)
    data = rng.uniform(size=(16, 8, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 1.5, size=(7, 9, 2)).astype(np.float32)
    tj = jtex.Texture(data=jnp.asarray(data), filter=filt, wrap=wrap)
    tt = ttex.Texture(data=torch.from_numpy(data), filter=filt, wrap=wrap)
    np.testing.assert_allclose(
        np.asarray(jtex.sample_texture(tj, jnp.asarray(uv))),
        ttex.sample_texture(tt, torch.from_numpy(uv)).numpy(), atol=1e-6)

