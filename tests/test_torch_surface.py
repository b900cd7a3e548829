"""PyTorch port, the rest of the public surface against the JAX package:
``render_rows``, ``render_msaa``, resize, the pixel formats,
``create_framebuffer``/``clear``, the mesh helpers, ``save_obj``, the
demo scenes, ``RenderConfig`` and the exports.

Frames come from JAX ``render_rows``/``render_msaa`` on its
``reference`` backend (jitted) and are compared with alpha exact and
depth and color in the typed depth-tie class (testing/compare.py
``assert_tie_class_equal``, atol 1e-3 as in tests/test_torch_render.py).
Triangle ids of row bands are compared exactly against the port's own
full frame. Elementwise functions are compared bit for bit where they
round the same operations in the same order, and within the
FMA-contraction class (1e-6) where XLA:CPU may contract their
multiply-adds. The plain versions of the kernels run: every tensor is on
the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu import framebuffer as jfb
from software_renderer_tpu.models import mesh as jmesh
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.models import shapes as jshapes
from software_renderer_tpu.models.obj import save_obj as jsave_obj
from software_renderer_tpu.ops import msaa as jmsaa
from software_renderer_tpu.ops import resize as jresize
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops import texture as jtex
from software_renderer_tpu.ops import transforms as jtf
from software_renderer_tpu.render import render_rows as jrender_rows
from software_renderer_tpu.testing.compare import assert_tie_class_equal
from software_renderer_tpu.utils.config import RenderConfig as JConfig
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch import framebuffer as tfb
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.models import shapes as tshapes
from software_renderer_tpu_torch.ops import binning as tbin
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops import resize as tresize
from software_renderer_tpu_torch.ops import transforms as ttf
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    visibility_pallas)
from software_renderer_tpu_torch.ops.rasterize_ref import visibility_ref
from software_renderer_tpu_torch.render import (planar_front_of,
                                                triangle_inputs)

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))
CPU = dict(device="cpu")
BACKENDS = ("auto", "pallas", "reference")
# (y_start, rows) at 64 rows: JAX's bands (tests/test_parallel.py) and a
# ragged one (neither a multiple of the 64-row tile nor of a band).
BANDS = ((0, 32), (16, 32), (32, 32), (5, 37))


def _jax_pass(rp):
    """The JAX RenderPass of a port RenderPass (on the CPU); its texture
    is handed the port's quad table, which equals JAX's (the table is not
    rebuilt op by op)."""
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    m = rp.mesh
    mesh = sr.Mesh(**{f: j(getattr(m, f)) for f in (
        "positions", "indices", "colors", "normals", "uvs")})
    light = None if rp.light is None else jsh.Light(
        *(j(getattr(rp.light, f.name)) for f in dataclasses.fields(
            rp.light)))
    tex = None if rp.texture is None else jtex.Texture(
        data=j(rp.texture.data), filter=rp.texture.filter,
        wrap=rp.texture.wrap, table=j(rp.texture.table), table_pack=1)
    return sr.RenderPass(
        mesh=mesh, transform=j(rp.transform), light=light, texture=tex,
        flat_color=j(rp.flat_color), model=j(rp.model),
        **{f: getattr(rp, f) for f in convert.STATIC_FIELDS})


def _assert_frames(fb_j, fb_t, context, atol=1e-3):
    cj, dj = np.asarray(fb_j.color), np.asarray(fb_j.depth)
    ct, dt = fb_t.color.numpy(), fb_t.depth.numpy()
    assert ct.shape == cj.shape and dt.shape == dj.shape, context
    assert np.isfinite(ct).all(), context
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3], err_msg=context)
    assert_tie_class_equal(cj, ct, dj, dt, atol=atol, context=context)


@pytest.fixture(scope="module")
def band_scene():
    """Config 2 at 128x64 (textured, lit, culled) and JAX's bands of it."""
    rp = tscenes.config2_textured_cube(0.7, width=128, height=64, **CPU)
    rows = jax.jit(jrender_rows, static_argnames=("rows", "backend"))
    return rp, {b: rows(_jax_pass(rp), b[0], rows=b[1], backend="reference")
                for b in BANDS}


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_rows_matches_jax(band_scene, backend):
    rp_t, bands_j = band_scene
    full = srt.render(rp_t, backend=backend)
    assert full.color[..., 3].any()
    _cuda.reset_launches()
    for (y0, rows), fb_j in bands_j.items():
        fb_t = srt.render_rows(rp_t, y0, rows, backend=backend)
        what = f"{backend} rows {y0}+{rows}"
        _assert_frames(fb_j, fb_t, what)
        # The band is the full frame's rows.
        band = slice(y0, y0 + rows)
        assert torch.equal(fb_t.color[..., 3], full.color[band, :, 3]), what
        assert_tie_class_equal(full.color[band].numpy(), fb_t.color.numpy(),
                               full.depth[band].numpy(), fb_t.depth.numpy(),
                               atol=1e-6, context=what)
    assert all(n == 0 for n in _cuda.launches.values()), _cuda.launches


@pytest.fixture(scope="module")
def banded_scene():
    """Config 4 cut to ~2,200 triangles at 256x128 (4-band layout)."""
    return tscenes.config4_many_objects(0.3, width=256, height=128,
                                        triangles=2200, **CPU)


@pytest.mark.parametrize("path", ["fused", "fused_spill", "binned",
                                  "pallas", "reference"])
def test_row_band_ids_equal_full_frame(banded_scene, path):
    """Triangle ids and depth of every band, ragged ones included, equal
    the full frame's rows bit for bit on each visibility path (spills on
    ``fused_spill``: kmax 1)."""
    rp = banded_scene
    w, h = rp.width, rp.height
    ps, chans, attrs, prm, lit, tex = triangle_inputs(rp)

    def vis(y0, rows):
        kw = dict(width=w, height=rows, y_start=y0)
        if path.startswith("fused"):
            extra = dict(kmax=1) if path == "fused_spill" else {}
            return tbin.fused_pipeline(
                ps, attrs, prm, chans=chans, has_light=lit, has_texture=tex,
                pair_budget_factor=0.85, **extra, **kw)[:2]
        if path == "binned":
            return tbin.visibility_binned(ps, pair_budget_factor=0.85, **kw)
        fn = visibility_pallas if path == "pallas" else visibility_ref
        return fn(tfe.to_setup(ps), **kw)

    d_full, i_full = vis(0, h)
    assert (i_full >= 0).any()
    for y0, rows in ((0, 64), (37, 60), (97, 31)):
        d, i = vis(y0, rows)
        assert torch.equal(i, i_full[y0:y0 + rows]), (path, y0, rows)
        assert torch.equal(d, d_full[y0:y0 + rows]), (path, y0, rows)


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_render_rows_with_precomputed_front(banded_scene, backend):
    """``front=`` (also zero-padded past the mesh) gives the band the
    front-end computes itself; the clip path refuses it."""
    rp = banded_scene
    ps = planar_front_of(rp)
    padded = tfe.PlanarSetup(*(torch.nn.functional.pad(
        getattr(ps, f.name), (0, 13)) for f in dataclasses.fields(ps)))
    want = srt.render_rows(rp, 37, 60, backend=backend)
    for front in (ps, padded):
        got = srt.render_rows(rp, 37, 60, backend=backend, front=front)
        assert torch.equal(got.color, want.color)
        assert torch.equal(got.depth, want.depth)
    with pytest.raises(ValueError, match="clip_near"):
        srt.render_rows(dataclasses.replace(rp, clip_near=True), 0, 8,
                        front=ps)


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_render_msaa_matches_jax(backend):
    rp = tscenes.config1_flat_cube(0.3, width=64, height=32, **CPU)
    fb_j = jmsaa.render_msaa(_jax_pass(rp), 2, backend="reference")
    fb_t = srt.render_msaa(rp, 2, backend=backend)
    _assert_frames(fb_j, fb_t, f"msaa {backend}")
    assert ((fb_t.color[..., 3] > 0) & (fb_t.color[..., 3] < 1)).any()


def test_render_msaa_is_the_box_of_the_large_frame():
    rp = tscenes.config1_flat_cube(0.3, width=48, height=32, **CPU)
    big = srt.render(dataclasses.replace(rp, width=96, height=64))
    fb = srt.render_msaa(rp, 2)
    assert fb.color.shape == (32, 48, 4)
    assert torch.equal(fb.depth, big.depth.reshape(32, 2, 48, 2).amin(
        dim=(1, 3)))
    assert torch.equal(srt.render_msaa(rp, 1).color, srt.render(rp).color)


_jax_bilinear = jax.jit(jresize.resize_bilinear, static_argnums=(1, 2))
_jax_nearest = jax.jit(jresize.resize_nearest, static_argnums=(1, 2))


@pytest.mark.parametrize("out", [(40, 31), (8, 9)])
def test_resize_matches_jax(out):
    """Up ([H, W, C]) and down ([H, W]): bilinear within the contraction
    class, nearest bit for bit."""
    rng = np.random.default_rng(1)
    img = rng.random((17, 23, 3), dtype=np.float32)
    x = img if out[0] > 17 else img[..., 1]
    np.testing.assert_allclose(
        np.asarray(_jax_bilinear(jnp.asarray(x), *out)),
        tresize.resize_bilinear(T(x), *out).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(_jax_nearest(jnp.asarray(x), *out)),
        tresize.resize_nearest(T(x), *out).numpy())


def _colors(rng):
    """RGBA values in and out of [0, 1], with exact quantization ties."""
    c = rng.uniform(-0.1, 1.1, (16, 24, 4)).astype(np.float32)
    c[0, :8] = np.arange(8, dtype=np.float32)[:, None] / 62.0 + 0.5 / 255
    return c


@pytest.mark.parametrize("fmt", sorted(jfb.PIXEL_FORMATS))
def test_pixel_formats_match_jax(fmt):
    rng = np.random.default_rng(2)
    c = _colors(rng)
    ej = np.asarray(jax.jit(jfb.encode_pixels, static_argnums=1)(
        jnp.asarray(c), fmt))
    et = srt.encode_pixels(T(c), fmt)
    assert str(et.dtype).split(".")[-1] == str(ej.dtype), fmt
    et = et.to(torch.int32 if fmt == "rgb565" else et.dtype).numpy()
    if fmt == "gray8":
        assert np.abs(ej.astype(np.int32) - et.astype(np.int32)).max() <= 1
        assert (ej == et).mean() > 0.99
    else:
        np.testing.assert_array_equal(ej.astype(et.dtype), et)
    # Decoding the same raw pixels.
    raw = ej
    # Op by op: under jit XLA:CPU turns x / 255 into a multiply by the
    # reciprocal, an ulp away from JAX's own division.
    dj = np.asarray(jfb.decode_pixels(jnp.asarray(raw), fmt))
    raw_t = T(raw.astype(np.int32)).to(torch.uint16) if fmt == "rgb565" \
        else T(raw)
    np.testing.assert_array_equal(dj, srt.decode_pixels(raw_t, fmt).numpy())
    assert srt.bytes_per_pixel(fmt) == jfb.bytes_per_pixel(fmt)
    assert tfb.PIXEL_FORMATS[fmt][:2] == jfb.PIXEL_FORMATS[fmt][:2]


def test_unknown_pixel_format_raises():
    with pytest.raises(ValueError, match="unknown pixel format"):
        srt.encode_pixels(torch.zeros(2, 2, 4), "rgb888")
    with pytest.raises(ValueError, match="unknown pixel format"):
        srt.decode_pixels(torch.zeros(2, 2), "rgb888")


def test_create_framebuffer_and_clear_match_jax():
    fj = jax.jit(jfb.create_framebuffer, static_argnums=(0, 1))(7, 5)
    ft = srt.create_framebuffer(7, 5, **CPU)
    np.testing.assert_array_equal(np.asarray(fj.color), ft.color.numpy())
    np.testing.assert_array_equal(np.asarray(fj.depth), ft.depth.numpy())
    assert ft.width == 7 and ft.height == 5
    cj = jax.jit(jfb.clear, static_argnums=(1, 2))(fj, (0.1, 0.2, 0.3, 1.0),
                                                   0.5)
    ct = srt.clear(ft, (0.1, 0.2, 0.3, 1.0), 0.5)
    np.testing.assert_array_equal(np.asarray(cj.color), ct.color.numpy())
    np.testing.assert_array_equal(np.asarray(cj.depth), ct.depth.numpy())
    np.testing.assert_array_equal(np.asarray(jfb.to_bgra8(cj.color)),
                                  srt.to_bgra8(ct.color).numpy())


def _meshes():
    """Three meshes with different attribute sets, in both packages."""
    rng = np.random.default_rng(3)
    out = []
    for n, attrs in ((5, ("colors", "normals", "uvs")), (4, ("normals",)),
                     (6, ())):
        kw = {"colors": rng.random((n, 3)), "normals": rng.normal(
            size=(n, 3)), "uvs": rng.random((n, 2))}
        kw = {k: v for k, v in kw.items() if k in attrs}
        pos = rng.normal(size=(n, 3))
        idx = rng.integers(0, n, 6)
        out.append((sr.mesh_from_numpy(pos, idx, **kw),
                    srt.mesh_from_numpy(pos, idx, **kw, **CPU)))
    return out


def _assert_mesh(mj, mt, exact=True):
    for f in ("positions", "indices", "colors", "normals", "uvs"):
        a, b = getattr(mj, f), getattr(mt, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if exact or f == "indices":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)


def test_merge_and_transform_mesh_match_jax():
    pairs = _meshes()
    merged_t = srt.merge_meshes([t for _, t in pairs])
    merged_j = jax.jit(jmesh.merge_meshes)([j for j, _ in pairs])
    _assert_mesh(merged_j, merged_t)
    m = ttf.trs_matrix(translation=(0.2, -0.1, 0.4),
                       rotation=ttf.quat_from_axis_angle(
                           T([0.0, 0.6, 0.8]), 0.7),
                       scale=(1.5, 0.5, 2.0)).numpy()
    mj = jax.jit(jmesh.transform_mesh)(merged_j, jnp.asarray(m))
    _assert_mesh(mj, srt.transform_mesh(merged_t, T(m)), exact=False)
    assert merged_t.lines().shape == (9, 2)


def test_save_obj_writes_jax_text(tmp_path):
    for i, (mj, mt) in enumerate(_meshes()):
        if mj.uvs is not None and mj.normals is None:
            continue
        jsave_obj(str(tmp_path / f"j{i}.obj"), mj)
        srt.save_obj(str(tmp_path / f"t{i}.obj"), mt)
        assert (tmp_path / f"j{i}.obj").read_text() == \
            (tmp_path / f"t{i}.obj").read_text()
        back = srt.load_obj(str(tmp_path / f"t{i}.obj"), **CPU)
        assert back.indices.numel() == mt.indices.numel()


@pytest.mark.parametrize("name", ["rotating_triangle", "wireframe_cube",
                                  "intersecting_triangles"])
def test_demo_scenes_match_jax(name):
    rj = jax.jit(getattr(jscenes, name), static_argnames=(
        "width", "height"))(0.6, width=96, height=64)
    rt = getattr(tscenes, name)(0.6, width=96, height=64, **CPU)
    _assert_mesh(rj.mesh, rt.mesh)
    np.testing.assert_allclose(np.asarray(rj.transform), rt.transform.numpy(),
                               rtol=0, atol=1e-6)
    for f in ("width", "height", "primitive", "shading", "cull_backfaces"):
        assert getattr(rj, f) == getattr(rt, f), f
    fb = srt.render(rt)
    assert fb.color.shape == (64, 96, 4) and fb.color[..., 3].any()


def test_plane_and_ndc_to_uv_match_jax():
    _assert_mesh(jshapes.plane(1.7), tshapes.plane(1.7, **CPU))
    p = np.random.default_rng(4).uniform(-1, 1, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jtf.project_ndc_to_uv(p)),
                                  ttf.project_ndc_to_uv(T(p)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jtf.project_ndc_to_uv_literal(p)),
        ttf.project_ndc_to_uv_literal(T(p)).numpy())


def test_render_config_round_trip_and_projection(tmp_path):
    cfg = srt.RenderConfig(width=320, height=180, msaa=2, shading="phong",
                           projection="perspective", obj_path="a.obj")
    assert srt.RenderConfig.from_json(cfg.to_json()) == cfg
    cfg.save(str(tmp_path / "c.json"))
    assert srt.RenderConfig.load(str(tmp_path / "c.json")) == cfg
    # The JSON is JAX's: each package reads the other's.
    jcfg = JConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert srt.RenderConfig.from_json(jcfg.to_json()) == cfg
    for c, j in ((cfg, jcfg), (srt.RenderConfig(), JConfig())):
        np.testing.assert_allclose(np.asarray(j.projection_matrix()),
                                   c.projection_matrix(**CPU).numpy(),
                                   rtol=0, atol=1e-6)


def test_exports_cover_jax_all():
    missing = set(sr.__all__) - set(srt.__all__)
    assert not missing, missing
    for name in srt.__all__:
        assert hasattr(srt, name), name
