"""PyTorch port, the camera path: the camera transforms, the near-plane
clip and perspective-correct attributes against the JAX package, module
by module and through ``render()`` on every backend.

JAX's clip, setup and perspective functions run op by op here (no
``jax.jit``), so each operation rounds once on both sides and the module
results are compared bit for bit; under jit XLA:CPU would contract
multiply-adds into FMAs. Frames come from JAX ``render(...,
"reference")`` (jitted) and are compared in the typed classes: coverage
(alpha) exact, depth and color with testing/compare.py
``assert_tie_class_equal`` at atol 1e-3 (planes evaluated at (x, y)
against barycentric dot products differ by ulps, the specular pow
amplifies them, and the perspective divide moves them by a few ulps
more). The plain versions of the kernels run: every tensor is on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.ops import binning as jbin
from software_renderer_tpu.ops import clip as jclip
from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.ops import resolve as jres
from software_renderer_tpu.ops import setup as jsetup
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops import transforms as jtf
from software_renderer_tpu.ops import vertex as jvx
from software_renderer_tpu.ops.rasterize_ref import (
    visibility_ref as jvisibility_ref)
from software_renderer_tpu.ops.texture import sample_texture as jsample
from software_renderer_tpu.testing.compare import assert_tie_class_equal
from software_renderer_tpu.testing.oracle import (oracle_clip_near,
                                                  oracle_rasterize)
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import clip as tclip
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops import resolve as tres
from software_renderer_tpu_torch.ops import setup as tsetup
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops import transforms as ttf
from software_renderer_tpu_torch.ops import vertex as tvx
from software_renderer_tpu_torch.ops.rasterize_ref import visibility_ref
from software_renderer_tpu_torch.render import clip_front

torch.set_num_threads(1)
CPU = dict(device="cpu")
T = lambda a: torch.from_numpy(np.array(a))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port(rp):
    return convert.render_pass_from_numpy(
        convert.arrays_of(rp), **CPU, **convert.static_fields_of(rp))


# ---------------------------------------------------------------------------
# Scenes (JAX side; the port gets them through convert)
# ---------------------------------------------------------------------------

def straddling_quad(shading="vertex", in_front=False, lit_uv=False):
    """tests/test_clip.py's quad under perspective() @ look_at: its near
    edge lies behind the eye (``in_front``: moved 2 units forward;
    ``lit_uv``: with uvs, up normals, a checkerboard and the default
    light, perspective-correct: interpolated affinely in screen space,
    every visible pixel takes the far edge's v, where the repeat seam
    samples one grey, so the uvs through the cut would go unchecked)."""
    positions = np.array([[-1.0, -0.3, 1.0], [1.0, -0.3, 1.0],
                          [1.0, -0.3, -4.0], [-1.0, -0.3, -4.0]], np.float32)
    if in_front:
        positions[:, 2] -= 2.0
    extra, lit = {}, {}
    if lit_uv:
        extra = dict(
            normals=np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1)),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        lit = dict(texture=sr.checkerboard(32, 4), light=sr.Light.default(),
                   perspective_correct=True)
    mesh = sr.mesh_from_numpy(
        positions, np.array([0, 1, 2, 0, 2, 3]),
        colors=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]],
                        np.float32), **extra)
    proj = jtf.perspective(np.pi / 3, 1.0, 0.1, 10.0)
    view = jtf.look_at(eye=(0.0, 0.4, 0.0), target=(0.0, -0.3, -2.0))
    return sr.RenderPass(mesh=mesh, transform=proj @ view, width=96,
                         height=96, shading=shading, clip_near=True, **lit)


def slanted_quad(lit=False):
    """tests/test_perspective.py's textured quad receding in depth."""
    positions = np.array([[-0.5, -0.2, -0.5], [0.5, -0.2, -0.5],
                          [0.5, -0.2, -3.0], [-0.5, -0.2, -3.0]], np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    mesh = sr.mesh_from_numpy(positions, np.array([0, 1, 2, 0, 2, 3]),
                              colors=np.ones((4, 3), np.float32), uvs=uvs,
                              normals=normals if lit else None)
    proj = jtf.perspective(np.pi / 3, 1.0, 0.1, 10.0)
    view = jtf.look_at(eye=(0.0, 0.3, 0.5), target=(0.0, -0.2, -2.0))
    return sr.RenderPass(
        mesh=mesh, transform=proj @ view, width=64, height=64,
        shading="textured", texture=sr.checkerboard(64, 8),
        perspective_correct=True,
        light=sr.Light.default() if lit else None,
        model=jnp.eye(4) if lit else None)


def camera_transform(model):
    """Config 4's model under a camera inside the object cloud."""
    return (jtf.perspective(np.pi / 3, 16 / 9, 0.05, 10.0)
            @ jtf.look_at((0.0, 0.0, 0.6), (0.0, 0.0, 1.6)) @ model)


def config4_camera(shading="textured"):
    """Config 4 cut to 2,940 triangles at 160x90 under the camera, clip
    and perspective on: 66 triangles straddle the eye plane, 30 of them
    with one corner behind it (two output triangles each)."""
    rp = jscenes.config4_many_objects(0.0, width=160, height=90,
                                      triangles=3000)
    return dataclasses.replace(rp, transform=camera_transform(rp.model),
                               shading=shading, clip_near=True,
                               perspective_correct=True)


_SCENES = {
    "straddle": straddling_quad,
    "straddle_flat": lambda: straddling_quad("flat"),
    "straddle_textured_lit": lambda: straddling_quad("textured",
                                                     lit_uv=True),
    "slanted": slanted_quad,
    "slanted_lit": lambda: slanted_quad(lit=True),
    "config4_camera": config4_camera,
    # Phong without texture: the lit plan's "final" output, clipped.
    "config4_camera_phong": lambda: config4_camera("phong"),
}


@pytest.fixture(scope="module")
def jax_frames():
    return {}


def _jax_frame(jax_frames, name):
    if name not in jax_frames:
        rp = _SCENES[name]()
        fb = sr.render(rp, backend="reference")
        jax_frames[name] = (rp, np.asarray(fb.color), np.asarray(fb.depth))
    return jax_frames[name]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fov,aspect,near,far,eye,target,up", [
    (np.pi / 3, 16 / 9, 0.05, 10.0, (0.0, 0.0, 0.6), (0.0, 0.0, 1.6),
     (0.0, 1.0, 0.0)),
    (np.pi / 3, 1.0, 0.1, 10.0, (0.0, 0.4, 0.0), (0.0, -0.3, -2.0),
     (0.0, 1.0, 0.0)),
    (1.1, 0.75, 0.5, 50.0, (3.0, -2.0, 1.5), (-1.0, 0.5, 0.25),
     (0.3, 0.9, 0.1))])
def test_camera_transforms_match_jax(fov, aspect, near, far, eye, target,
                                     up):
    """perspective, look_at and identity: within 2 float32 ulps of each
    entry's magnitude (tan and the dot products may round differently)."""
    for j, t in ((jtf.perspective(fov, aspect, near, far),
                  ttf.perspective(fov, aspect, near, far, **CPU)),
                 (jtf.look_at(eye, target, up),
                  ttf.look_at(eye, target, up, **CPU)),
                 (jtf.identity(), ttf.identity(**CPU))):
        j = np.asarray(j)
        assert t.dtype == torch.float32 and t.shape == (4, 4)
        np.testing.assert_allclose(t.numpy(), j, rtol=2.4e-7, atol=1e-7)


def _clip_case(case, n=64, seed=0):
    """[n, 3, 4] clip-space triangles whose corners are behind the plane
    w = CLIP_EPS exactly where ``case`` (b0 + 2 b1 + 4 b2) says, some on
    it and some with two equal w."""
    rng = np.random.default_rng(seed + case)
    c = rng.uniform(-2.0, 2.0, (n, 3, 4)).astype(np.float32)
    for k in range(3):
        behind = (case >> k) & 1
        c[:, k, 3] = (rng.uniform(-2.0, -1e-3, n) if behind
                      else rng.uniform(1e-3, 2.0, n))
    c[0, :, 3] = np.where([(case >> k) & 1 for k in range(3)], -0.5, 0.5)
    c[1, :, 3] = np.where([(case >> k) & 1 for k in range(3)],
                          -1e-7, np.float32(jclip.CLIP_EPS))
    return c


@pytest.mark.parametrize("case", range(8))
def test_clip_near_matches_jax(case):
    """clip_near on every behind-mask case: corners, barycentric weights
    and validity bit for bit; compose_attrs through the clip."""
    c = _clip_case(case)
    cj, bj, vj = jclip.clip_near(jnp.asarray(c))
    ct, bt, vt = tclip.clip_near(T(c))
    for a, b in ((cj, ct), (bj, bt), (vj, vt)):
        _eq(a, b.numpy())
    n = c.shape[0]
    valid = vt.numpy()
    assert valid[:n].all() == (case != 7) and not valid[:n][...].any() == (
        case == 7)
    assert valid[n:].any() == jclip._TRI2_VALID[case]
    attrs = np.random.default_rng(case).uniform(
        -1, 1, (n, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tclip.compose_attrs(bt, T(attrs)).numpy(),
        np.asarray(jclip.compose_attrs(bj, jnp.asarray(attrs))),
        rtol=2.4e-7, atol=1e-7)
    # The case-0 slots pass their corners and attributes through exactly.
    if case == 0:
        _eq(ct[:n].numpy(), c)
        _eq(tclip.compose_attrs(bt, T(attrs))[:n].numpy(), attrs)


def test_transform_corners_clip_matches_jax():
    rng = np.random.default_rng(4)
    corners = rng.uniform(-2, 2, (64, 3, 3)).astype(np.float32)
    m = np.asarray(camera_transform(jnp.eye(4)))
    _eq(jclip.transform_corners_clip(jnp.asarray(corners), jnp.asarray(m)),
        tclip.transform_corners_clip(T(corners), T(m)).numpy())
    _eq(jclip.cull_behind_mask(jclip.transform_corners_clip(
        jnp.asarray(corners), jnp.asarray(m))),
        tclip.cull_behind_mask(tclip.transform_corners_clip(
            T(corners), T(m))).numpy())


def test_vertex_stage_matches_jax():
    """transform_vertices: the port's multiply-add chains against JAX's
    full-precision dot within 2 ulps; ndc_to_screen of the same NDC bit
    for bit; corner_stage is vertex_stage over the corners."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pos[:, 2] += 1.5
    m = np.asarray(camera_transform(jnp.eye(4)))
    nj, wj = jvx.transform_vertices(jnp.asarray(pos), jnp.asarray(m))
    nt, wt = tvx.transform_vertices(T(pos), T(m))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=2.4e-7,
                               atol=1e-7)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=5e-7,
                               atol=1e-6)
    _eq(jvx.ndc_to_screen(nj, 160, 90),
        tvx.ndc_to_screen(T(np.asarray(nj)), 160, 90).numpy())
    st, w2 = tvx.vertex_stage(T(pos), T(m), 160, 90)
    sc, wc = tvx.corner_stage(T(pos).reshape(100, 3, 3), T(m), 160, 90)
    assert torch.equal(sc.reshape(300, 3), st)
    assert torch.equal(wc.reshape(300), w2)


def _screen_corners(n, seed, w=160, h=90):
    """[n, 3, 3] rounded screen corners: small and large triangles, some
    past the frame, degenerate, NaN and offscreen ones."""
    rng = np.random.default_rng(seed)
    xy = np.round(rng.uniform(-60, 220, (n, 1, 2))
                  + rng.uniform(-25, 25, (n, 3, 2)))
    z = rng.uniform(0, 1, (n, 3, 1))
    v = np.concatenate([xy, z], -1).astype(np.float32)
    v[0, 1] = v[0, 0]                       # degenerate
    v[1, 2, 0] = np.nan                     # NaN corner
    v[2, :, 0] = 5000.0                     # offscreen
    v[3, :, :2] = [[-3000, -2000], [4000, 10], [7, 3500]]   # huge
    return v


@pytest.mark.parametrize("cull", [False, True])
def test_triangle_setup_from_corners_matches_jax(cull):
    """The array setup with a validity mask (the clip's), op by op: every
    field bit for bit, the invalid fills included; triangle_setup gathers
    the same corners."""
    v = _screen_corners(128, 6)
    extra = np.random.default_rng(6).uniform(size=128) < 0.8
    sj = jsetup.triangle_setup_from_corners(
        jnp.asarray(v), 160, 90, cull_backfaces=cull,
        extra_valid=jnp.asarray(extra))
    st = tsetup.triangle_setup_from_corners(
        T(v), 160, 90, cull_backfaces=cull, extra_valid=T(extra))
    for f in ("coef", "zplane", "inv_area", "bbox", "valid", "area2", "safe"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert a.dtype == b.dtype, f
        _eq(a, b)
    valid = st.valid.numpy()
    assert valid.any() and not valid[:3].any() and not valid[~extra].any()
    tris = np.arange(128 * 3).reshape(128, 3)[::-1].copy()
    s2 = tsetup.triangle_setup(T(v.reshape(-1, 3)), T(tris), 160, 90,
                               cull_backfaces=cull)
    assert torch.equal(s2.valid, tsetup.triangle_setup_from_corners(
        T(v.reshape(-1, 3)[tris]), 160, 90, cull_backfaces=cull).valid)


def test_from_setup_is_the_inverse_of_to_setup():
    """The planar view of a TriangleSetup carries its values: to_setup of
    the view is the setup, and its columns are those the planar front-end
    computes for the same corners."""
    v = _screen_corners(200, 7)
    st = tsetup.triangle_setup_from_corners(T(v), 160, 90)
    back = tfe.to_setup(tfe.from_setup(st))
    for f in ("coef", "zplane", "inv_area", "bbox", "valid", "area2", "safe"):
        a, b = getattr(st, f), getattr(back, f)
        assert torch.equal(a.isnan(), b.isnan()) and bool(
            ((a == b) | a.isnan()).all()), f
    view = tfe.from_setup(st)
    assert torch.equal(view.abs_d, torch.where(st.valid, st.area2.abs(), 0.0))
    assert bool(view.w1.isnan().all())


def test_corner_w_and_perspective_chan_vals_match_jax():
    rng = np.random.default_rng(8)
    corners = rng.uniform(-1.2, 1.2, (97, 3, 3)).astype(np.float32)
    m = np.asarray(camera_transform(jnp.eye(4)))
    ps_j = jfe.planar_front(jfe.corner_cols(jnp.asarray(corners)),
                            jnp.asarray(m), 160, 90, pallas=False)
    ps_t = convert.planar_setup_from_numpy(ps_j, **CPU)
    _eq(jfe.corner_w(ps_j), tfe.corner_w(ps_t).numpy())
    vals = np.random.default_rng(8).uniform(
        -1, 1, (ps_t.num_triangles, 3, 4)).astype(np.float32)
    pj = jfe.perspective_chan_vals(jfe.attr_corner_cols(jnp.asarray(vals)),
                                   ps_j)
    pt = tfe.perspective_chan_vals(tfe.attr_corner_cols(T(vals)), ps_t)
    assert len(pt) == len(pj) == 5
    for cj, ct in zip(pj, pt):
        for a, b in zip(cj, ct):
            _eq(a, b.numpy())


def test_attribute_planes_equal_plane_columns():
    """The [T, 3, A] form of the planes (the clip path's table) gives
    attribute_plane_cols' values bit for bit, NaN where a value is."""
    v = _screen_corners(128, 13)
    ps = tfe.from_setup(tsetup.triangle_setup_from_corners(T(v), 160, 90))
    vals = np.random.default_rng(13).uniform(-1, 1, (128, 3, 9)).astype(
        np.float32)
    vals[5, 1, 2] = np.nan
    got = tfe.attribute_planes(ps, T(vals))
    want = torch.stack(tfe.attribute_plane_cols(
        ps, tfe.attr_corner_cols(T(vals))), dim=1)
    _eq(got.numpy(), want.numpy())
    assert bool(got[5].isnan().any())


def test_perspective_vertex_attrs_and_weights_match_jax():
    rng = np.random.default_rng(9)
    attrs = rng.uniform(-1, 1, (50, 3, 8)).astype(np.float32)
    w = rng.uniform(0.05, 3.0, (50, 3)).astype(np.float32)
    w[0, 1] = 0.0
    _eq(jsh.perspective_vertex_attrs(jnp.asarray(attrs), jnp.asarray(w)),
        tsh.perspective_vertex_attrs(T(attrs), T(w)).numpy())
    ws = rng.uniform(-0.1, 1, (12, 16, 3)).astype(np.float32)
    tid = rng.integers(-1, 50, (12, 16)).astype(np.int32)
    cov = tid >= 0
    got = tres.perspective_correct_weights(T(ws), T(w), T(tid), T(cov))
    want = jres.perspective_correct_weights(
        jnp.asarray(ws), jnp.asarray(w), jnp.asarray(tid), jnp.asarray(cov))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-7,
                               atol=1e-7)


def test_perspective_epilogue_divides_by_the_last_plane():
    """The plain perspective plan: every channel over the interpolated
    1/w on covered pixels, the inner epilogue's zeros elsewhere."""
    rng = np.random.default_rng(10)
    planes = [T(rng.uniform(-1, 1, (6, 7)).astype(np.float32))
              for _ in range(3)] + [T(rng.uniform(0.2, 2, (6, 7)).astype(
                  np.float32))]
    cov = T(rng.uniform(size=(6, 7)) < 0.7)
    out = tsh.perspective_epilogue(
        planes, cov, tsh.shading_params(None, device="cpu"),
        inner=lambda p, c, q: tsh.fused_epilogue(
            p, c, q, chans=[("rgb", 3)], has_light=False, has_texture=False))
    for o, p in zip(out, planes[:3]):
        want = torch.where(cov, p * (1.0 / planes[3]), 0.0)
        assert torch.equal(o, want)


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,backend", [
    (n, b) for n in ("straddle", "straddle_textured_lit", "slanted",
                     "slanted_lit", "config4_camera")
    for b in ("auto", "pallas", "reference")]
    + [("straddle_flat", "auto"), ("config4_camera_phong", "auto")])
def test_camera_render_matches_jax_reference(jax_frames, name, backend):
    """render() with clip_near and/or perspective_correct against JAX's
    reference backend: alpha exact, depth and color in the tie class."""
    rp, cj, dj = _jax_frame(jax_frames, name)
    _cuda.reset_launches()
    fb = srt.render(_port(rp), backend=backend)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    ct, dt = fb.color.numpy(), fb.depth.numpy()
    assert ct.shape == cj.shape and dt.shape == dj.shape
    assert ct[..., 3].mean() > 0.01, "nothing covered: vacuous"
    assert np.isfinite(ct).all()
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt, atol=1e-3,
                           context=f"{name} {backend}")


def test_clipped_ids_match_jax():
    """The clip front-end's [2T] setup against JAX's (op by op), on 64
    triangles around the eye (the module tests' shapes, so JAX compiles
    each operation once): every field bit for bit, the visibility pass's
    ids and coverage exact, depth in the contraction class (4 ulps of the
    plane chain)."""
    rng = np.random.default_rng(17)
    corners = (rng.uniform(-1.5, 1.5, (64, 1, 3))
               + rng.uniform(-0.6, 0.6, (64, 3, 3))).astype(np.float32)
    corners[..., 2] += 2.0       # around the eye at z = 0.6
    rp = dataclasses.replace(config4_camera(),
                             transform=camera_transform(jnp.eye(4)))
    clip, bary, cvalid = jclip.clip_near(jclip.transform_corners_clip(
        jnp.asarray(corners), rp.transform))
    w = clip[:, :, 3]
    ndc = clip[:, :, :3] / jnp.where(w == 0.0, 1.0, w)[:, :, None]
    screen = jvx.ndc_to_screen(ndc.reshape(-1, 3), rp.width,
                               rp.height).reshape(-1, 3, 3)
    sj = jsetup.triangle_setup_from_corners(
        screen, rp.width, rp.height, cull_backfaces=rp.cull_backfaces,
        extra_valid=cvalid)
    st, bt, wt = clip_front(T(corners), T(np.asarray(rp.transform)),
                                    rp.width, rp.height,
                                    cull_backfaces=rp.cull_backfaces)
    _eq(bary, bt.numpy())
    _eq(w, wt.numpy())
    for f in ("coef", "zplane", "bbox", "valid", "safe"):
        _eq(getattr(sj, f), getattr(st, f).numpy())
    dj, ij = jvisibility_ref(sj, width=rp.width, height=rp.height)
    dt, it = visibility_ref(st, width=rp.width, height=rp.height)
    _eq(ij, it.numpy())
    ij = np.asarray(ij)
    t = corners.shape[0]
    assert np.asarray(cvalid)[t:].any() and (ij >= t).any()
    assert (ij >= 0).mean() > 0.2
    cov = ij >= 0
    zp = st.zplane.numpy()[ij[cov]]
    yy, xx = np.nonzero(cov)
    mag = (np.abs(zp[:, 0] * (xx + 0.5)) + np.abs(zp[:, 1] * (yy + 0.5))
           + np.abs(zp[:, 2]))
    err = np.abs(np.asarray(dj)[cov].astype(np.float64) - dt.numpy()[cov])
    assert (err <= 2.0 ** -21 * mag).all()


def test_clip_front_table_plain_matches_jax():
    """The main path's clip front-end in torch operations (ops/clip.py
    ``clip_front_table_plain``, the plain version of the clip front-end
    kernel) against the JAX package's XLA clip path, op by op: corner and
    attribute gathers (JAX bakes the normal matrix into the vertices'
    normals, the port rotates the gathered ones), clip, setup, the
    channels through the clip over w with 1/w, and JAX's
    ``build_stream_table``. 64 textured, lit triangles around the eye at
    160x90, some vertices shared: every setup column and the table bit
    for bit but the normals' planes, and cut triangles fill second
    slots."""
    rng = np.random.default_rng(23)
    t = 64
    corners = (rng.uniform(-1.5, 1.5, (t, 1, 3))
               + rng.uniform(-0.6, 0.6, (t, 3, 3))).astype(np.float32)
    corners[..., 2] += 2.0       # around the eye at z = 0.6
    positions = corners.reshape(3 * t, 3)
    idx = np.arange(3 * t, dtype=np.int32)
    idx[5::9] = idx[1::9][:idx[5::9].size]        # shared vertices
    colors = rng.uniform(0.0, 1.0, (3 * t, 3)).astype(np.float32)
    normals = rng.normal(size=(3 * t, 3)).astype(np.float32)
    uvs = rng.uniform(0.0, 1.0, (3 * t, 2)).astype(np.float32)
    nm = np.asarray(jtf.inverse_transpose_3x3(jtf.rotation_matrix(
        jtf.quat_from_axis_angle(jnp.array([0.3, 1.0, 0.2]) / 1.06,
                                 0.7))[:3, :3]))
    m = np.asarray(camera_transform(jnp.eye(4)))
    ps, (table, n, _) = tclip.clip_front_table_plain(
        T(positions), T(idx), [(T(colors), False), (T(normals), True),
                               (T(uvs), False)], T(nm), T(m), 160, 90,
        perspective=True)

    tris = jnp.asarray(idx.reshape(t, 3))
    clip, bary, cvalid = jclip.clip_near(jclip.transform_corners_clip(
        jnp.asarray(positions)[tris], jnp.asarray(m)))
    w = clip[:, :, 3]
    ndc = clip[:, :, :3] / jnp.where(w == 0.0, 1.0, w)[:, :, None]
    screen = jvx.ndc_to_screen(ndc.reshape(-1, 3), 160, 90).reshape(-1, 3, 3)
    sj = jsetup.triangle_setup_from_corners(screen, 160, 90,
                                            extra_valid=cvalid)
    attrs, chans = jsh.gather_attribute_values(
        "textured", tris, colors=jnp.asarray(colors),
        normals=jnp.asarray(normals) @ jnp.asarray(nm).T,
        uvs=jnp.asarray(uvs))
    attrs = jsh.perspective_vertex_attrs(jclip.compose_attrs(bary, attrs), w)
    tj, nj, _ = jbin.build_stream_table(sj, attrs)

    coef = torch.stack([torch.stack([getattr(ps, r + str(k)) for k in range(3)],
                                    dim=-1) for r in "abc"], dim=-2)
    _eq(sj.coef, coef.numpy())
    _eq(sj.zplane, torch.stack([ps.zx, ps.zy, ps.zc], dim=-1).numpy())
    _eq(sj.bbox, torch.stack([ps.bx0, ps.by0, ps.bx1, ps.by1], dim=-1).numpy())
    for f in ("valid", "safe", "inv_area", "area2"):
        _eq(getattr(sj, f), getattr(ps, f).numpy())
    assert n == nj == 9 and chans == [("rgb", 3), ("normal", 3), ("uv", 2)]
    # The normal channels' planes (columns 20-28) within 2^-16 of each
    # entry: JAX's product with the normal matrix rounds some normals an
    # ulp apart from the port's multiply-add chain (render.py
    # shading_inputs), and the planes' differences of products amplify it.
    tj, tt = np.asarray(tj), table.numpy()
    normal = np.zeros(tj.shape[1], bool)
    normal[20:29] = True
    _eq(tj[:, ~normal], tt[:, ~normal])
    np.testing.assert_allclose(tt[:, normal], tj[:, normal], rtol=2 ** -16,
                               atol=0)
    assert bool(ps.valid[t:].any()) and int(ps.valid.sum()) > 20


def test_fused_perspective_uv_matches_oracle_math():
    """The port's binned frame of the slanted quad equals the closed-form
    projective interpolation (JAX's corrected weights from the winner
    map, then its sampler), as tests/test_perspective.py checks JAX's."""
    rp = slanted_quad()
    fb = srt.render(_port(rp))

    @jax.jit   # one compile; atol 2e-3 holds FMA contraction's ulps
    def oracle(rp):
        screen, w = jvx.vertex_stage(rp.mesh.positions, rp.transform, 64, 64)
        tris = rp.mesh.triangles()
        setup = jsetup.triangle_setup(screen, tris, 64, 64)
        _, tid = jvisibility_ref(setup, width=64, height=64)
        ws, covered = jres.barycentrics_at_pixels(setup, tid)
        wc = jres.perspective_correct_weights(ws, w[tris], tid, covered)
        uv_ref = jnp.einsum("hwk,hwkc->hwc", wc,
                            rp.mesh.uvs[tris][jnp.where(covered, tid, 0)])
        return covered, jnp.where(covered[..., None],
                                  jsample(rp.texture, uv_ref)[..., :3], 0.0)

    covered, want = (np.asarray(x) for x in oracle(rp))
    cov = covered
    assert cov.sum() > 200
    np.testing.assert_allclose(fb.color.numpy()[..., :3][cov], want[cov],
                               atol=2e-3)


@pytest.mark.parametrize("name,backend", [
    ("quad", "auto"), ("quad", "pallas"), ("quad", "reference"),
    ("config4", "auto"), ("config4_persp", "auto"),
    ("config4_persp", "pallas")])
def test_clip_noop_when_all_in_front(name, backend):
    """A scene wholly in front of the near plane renders the same frame
    with clip_near as without, bit for bit (case 0 keeps its corners and
    the planar front-end's arithmetic)."""
    if name == "quad":
        rp = _port(straddling_quad(in_front=True))
    else:
        rp = tscenes.config4_many_objects(
            0.0, width=160, height=96, triangles=3000, **CPU)
        rp = dataclasses.replace(rp, perspective_correct=name.endswith(
            "persp"))
    plain = srt.render(dataclasses.replace(rp, clip_near=False),
                       backend=backend)
    clipped = srt.render(dataclasses.replace(rp, clip_near=True),
                         backend=backend)
    assert plain.color[..., 3].mean() > 0.01
    assert torch.equal(plain.color, clipped.color)
    assert torch.equal(plain.depth, clipped.depth)


def test_clip_matches_numpy_oracle():
    """The port's clip against testing/oracle.py's Sutherland-Hodgman:
    the valid clipped triangles' pixel corners exact (depth within 2
    ulps), and the reference frame's coverage exact, colors within 2e-3,
    as tests/test_clip.py holds JAX's."""
    rp = straddling_quad()
    positions = np.asarray(rp.mesh.positions)
    tris = np.asarray(rp.mesh.triangles())
    m = np.asarray(rp.transform)
    screen_o, bary_o, src = oracle_clip_near(positions[tris], m, 96, 96)
    setup, bary, w = clip_front(T(positions[tris]), T(m), 96, 96)
    valid = setup.valid.numpy()
    t = tris.shape[0]
    slots = np.nonzero(valid)[0]
    # The oracle lists each source triangle's fan in order: slot t, then
    # slot T + t.
    order = np.lexsort((slots >= t, slots % t))
    slots = slots[order]
    np.testing.assert_array_equal(slots % t, src)
    clip = tclip.clip_near(tclip.transform_corners_clip(
        T(positions[tris]), T(m)))[0]
    wv = clip[:, :, 3:4]
    screen = tvx.ndc_to_screen((clip[:, :, :3] / wv).reshape(-1, 3), 96,
                               96).reshape(-1, 3, 3).numpy()[slots]
    np.testing.assert_array_equal(screen[..., :2], screen_o[..., :2])
    np.testing.assert_allclose(screen[..., 2], screen_o[..., 2], rtol=2.4e-7)
    np.testing.assert_allclose(bary.numpy()[slots], bary_o, atol=1e-6)
    colors = np.asarray(rp.mesh.colors)
    colors_tri = np.einsum("kij,kja->kia", bary_o,
                           colors[tris][src]).astype(np.float32)
    k = screen_o.shape[0]
    orc_c, _, _ = oracle_rasterize(screen_o.reshape(k * 3, 3),
                                   np.arange(k * 3).reshape(k, 3),
                                   colors_tri, 96, 96)
    ours = srt.render(_port(rp), backend="reference").color.numpy()
    np.testing.assert_array_equal(ours[..., 3], orc_c[..., 3])
    assert (ours[..., 3] > 0).mean() > 0.2
    cov = orc_c[..., 3] > 0
    np.testing.assert_allclose(ours[cov], orc_c[cov], atol=2e-3)
