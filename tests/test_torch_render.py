"""PyTorch port, the whole slice: ``render()`` against the JAX package's
``render(..., backend="reference")`` on the same scene (carried across
with software_renderer_tpu_torch.convert), plus the scene generators and
the rejection of a batch of transforms.

Alpha (coverage) is bit-equal. Color uses the repo's typed depth-tie
class (testing/compare.py assert_tie_class_equal) at atol 1e-3: planes
evaluated at (x, y) versus barycentric dot products differ by ulps, and
the specular pow amplifies them (the JAX package's own binned-vs-
reference test uses 1e-3, tests/test_binning.py).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.models import shapes as jshapes
from software_renderer_tpu.testing.compare import assert_tie_class_equal
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.models import shapes as tshapes

torch.set_num_threads(1)


def _port_of(rp, device="cpu"):
    return convert.render_pass_from_numpy(
        convert.arrays_of(rp), device=device, **convert.static_fields_of(rp))


def _jax_scene(name):
    if name == "config1":     # vertex colors: the unlit, untextured plan
        return jscenes.config1_flat_cube(0.3, width=96, height=96)
    if name == "config2":
        return jscenes.config2_textured_cube(0.7, width=128, height=96)
    # ~3000 triangles: T < 4096 keeps JAX on its XLA front-end, and
    # T >= 2048 sends the port down its banded (4-band) path. Untextured
    # Phong is the lit plan without the texture tail.
    return jscenes.config4_many_objects(
        0.0, width=320, height=192, triangles=3000,
        textured=name == "config4")


@pytest.mark.parametrize("name",
                         ["config1", "config2", "config4", "config4_phong"])
def test_render_matches_jax_reference(name):
    rp = _jax_scene(name)
    fb_j = sr.render(rp, backend="reference")
    _cuda.reset_launches()
    fb_t = srt.render(_port_of(rp))
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    cj, dj = np.asarray(fb_j.color), np.asarray(fb_j.depth)
    ct, dt = fb_t.color.numpy(), fb_t.depth.numpy()
    assert ct.shape == cj.shape and dt.shape == dj.shape
    assert ct[..., 3].any(), "nothing covered: vacuous"
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt, atol=1e-3, context=name)


def test_config4_mesh_equals_jax():
    mj = jshapes.many_objects_scene(target_triangles=100_000)
    mt = tshapes.many_objects_scene(target_triangles=100_000,
                                    device="cpu")
    for f in ("positions", "indices", "colors", "normals", "uvs"):
        a = np.asarray(getattr(mj, f))
        b = getattr(mt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_config3_teapot_mesh_equals_jax():
    from software_renderer_tpu.models.obj import load_obj as jload_obj
    mj = jload_obj(str(tscenes.TEAPOT_OBJ))
    rt = tscenes.config3_phong_mesh(0.5, width=128, height=128,
                                    device="cpu")
    for f in ("positions", "indices", "colors", "normals", "uvs"):
        np.testing.assert_array_equal(np.asarray(getattr(mj, f)),
                                      getattr(rt.mesh, f).numpy(), err_msg=f)
    fb = srt.render(rt)
    assert bool(torch.isfinite(fb.color).all())
    assert bool(fb.color[..., 3].any())


def test_load_obj_matches_jax(tmp_path):
    """A quad, relative indices and no normals (computed): the same
    arrays as the JAX package's reader; bad indices and faceless files
    raise."""
    from software_renderer_tpu.models.obj import load_obj as jload_obj
    from software_renderer_tpu_torch.models.obj import load_obj
    path = tmp_path / "m.obj"
    path.write_text(
        "# test\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "f 1 2 3 4\nf -1 -4 -3\n")
    mj, mt = jload_obj(str(path)), load_obj(str(path), device="cpu")
    for f in ("positions", "indices", "colors", "normals", "uvs"):
        np.testing.assert_array_equal(np.asarray(getattr(mj, f)),
                                      getattr(mt, f).numpy(), err_msg=f)
    path.write_text("v 0 0 0\nvn 0 0 1\nf 1//1 1//1 5//1\n")
    with pytest.raises(IndexError):
        load_obj(str(path), device="cpu")
    path.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no OBJ face data"):
        load_obj(str(path), device="cpu")


def test_port_scenes_render_like_converted_ones():
    """The port's own scene builders give the JAX scene's mesh and a
    renderable frame (transforms may differ by sin/cos ulps)."""
    rj = jscenes.config2_textured_cube(0.4, width=128, height=96)
    rt = tscenes.config2_textured_cube(0.4, width=128, height=96,
                                      device="cpu")
    np.testing.assert_array_equal(np.asarray(rj.mesh.positions),
                                  rt.mesh.positions.numpy())
    np.testing.assert_allclose(np.asarray(rj.transform),
                               rt.transform.numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(rj.texture.data),
                                  rt.texture.data.numpy())
    fb = srt.render(rt)
    assert fb.color.shape == (96, 128, 4) and bool(fb.color[..., 3].any())
    for build in (tscenes.config1_flat_cube, tscenes.reference_sphere):
        fb = srt.render(build(0.3, width=128, height=64, device="cpu"))
        assert bool(torch.isfinite(fb.color).all())
        assert bool(fb.color[..., 3].any())


def test_to_rgba8_matches_jax():
    x = np.linspace(-0.2, 1.2, 64, dtype=np.float32).reshape(4, 4, 4)
    np.testing.assert_array_equal(np.asarray(sr.to_rgba8(x)),
                                  srt.to_rgba8(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("backend", ["auto"])
def test_render_rejects_a_batch_of_transforms(backend):
    """A [B, 4, 4] transform is a TypeError in both packages (JAX's fails
    to broadcast); batches go through parallel.batch.render_batch."""
    rp_j = jscenes.config1_flat_cube(0.3, width=64, height=64)
    with pytest.raises(TypeError):
        sr.render(dataclasses.replace(
            rp_j, transform=jnp.broadcast_to(rp_j.transform, (2, 4, 4))),
            backend=backend)
    rp = _port_of(rp_j)
    with pytest.raises(TypeError, match="render_batch"):
        srt.render(dataclasses.replace(
            rp, transform=rp.transform.expand(2, 4, 4)), backend=backend)


def test_render_of_a_budget_spill_frame_matches_jax(monkeypatch):
    """render() of config 4's scene (3000 triangles) in untextured Phong
    at 3840x2160 under bench.py's orbit frame 240, where the culled pair
    budget spills 454 of its 1,275 valid triangles to the overflow path
    (K3's merge, K4's resolve and K2's seeded walk), against the JAX
    package's reference visibility pass and shading on rows [864, 928),
    where most of the spilled triangles' winning pixels lie (the JAX
    reference tests every triangle on every pixel: the whole frame takes
    it ~45 s). Both sides start from the port's planar setup, so the
    coverage decisions are one set; ids and coverage are exact, depth
    within the contraction class, color by the typed tie class (the
    shading jitted, as JAX's render is)."""
    from software_renderer_tpu.ops import frontend as jfe
    from software_renderer_tpu.ops import transforms as jtf
    from software_renderer_tpu.ops.rasterize_ref import visibility_ref
    from software_renderer_tpu.ops.shading import shade as jshade
    from software_renderer_tpu_torch.ops import binning as tbin
    from software_renderer_tpu_torch.render import planar_front_of
    rp = jscenes.config4_many_objects(0.0, width=3840, height=2160,
                                      triangles=3000, textured=False)
    q = jtf.quat_from_axis_angle(jtf.normalize(jnp.array([1.0, 1.0, 0.0])),
                                 240 / 60.0)
    rp = dataclasses.replace(rp, transform=rp.transform
                             @ jtf.rotation_matrix(q))
    rt = _port_of(rp)
    kept = {}
    fused = tbin.fused_kernel

    def keep(*a, **k):
        kept["out"] = fused(*a, **k)
        return kept["out"]

    monkeypatch.setattr(tbin, "fused_kernel", keep)
    tbin.reset_spill_counts("cpu")
    fb = srt.render(rt)
    spilled = tbin.spill_counts("cpu")
    ps = planar_front_of(rt)
    assert spilled["frames"] == 1
    assert spilled["budget"] >= 0.25 * int(ps.valid.sum())

    y0, rows = 864, 64
    band = slice(y0, y0 + rows)
    st = jfe.to_setup(jfe.PlanarSetup(**{
        f.name: jnp.asarray(getattr(ps, f.name).numpy())
        for f in dataclasses.fields(ps)}))
    dj, ij = visibility_ref(st, width=rp.width, height=rows, y_start=y0)
    mesh = rp.mesh
    cj = jax.jit(partial(jshade, shading="phong", y_start=y0))(
        st, ij, mesh.triangles(), colors=mesh.colors, normals=mesh.normals,
        uvs=mesh.uvs, light=rp.light, flat_color=rp.flat_color,
        normal_matrix=jtf.inverse_transpose_3x3(rp.model[:3, :3]))
    it = kept["out"][1][band]
    ov = tbin.build_bins(ps, width=rp.width, height=rp.height, kmax=48,
                         pair_budget_factor=0.85, bands=4).overflow_mask
    assert int(ov[it[it >= 0].long()].sum()) > 5000, "no spilled winners"
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    ct, dt = fb.color[band].numpy(), fb.depth[band].numpy()
    cj, dj = np.asarray(cj), np.asarray(dj)
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    win = it.numpy()
    cov = win >= 0
    yy, xx = np.nonzero(cov)
    yy = yy + y0
    mag = (np.abs(ps.zx.numpy()[win[cov]] * (xx + 0.5))
           + np.abs(ps.zy.numpy()[win[cov]] * (yy + 0.5))
           + np.abs(ps.zc.numpy()[win[cov]]))
    assert (np.abs(dj[cov].astype(np.float64) - dt[cov])
            <= 2.0 ** -21 * mag).all()
    assert_tie_class_equal(cj, ct, dj, dt, atol=1e-3, context="uhd spill")
