"""PyTorch port, the line and point primitives and the 2D primitives
against the JAX package: ``scatter_points`` (the last writer wins),
``draw_points``, ``draw_lines``, ``render`` of ``primitive="line"`` and
``"vertices"``, and ops/primitives2d.py, at 96x64.

JAX runs under ``jax.jit``. The class: the set of written pixels equal
to JAX's and colors within 1e-6, except on pixels whose rounding or edge
test sits within a few float32 ulps of its boundary (XLA:CPU may
contract ``a + d * frac`` into an FMA, moving such a sample by one
pixel); :func:`assert_primitive_class` finds those pixels, checks that
every differing pixel is one of them, and allows at most 0.1% of the
frame. The JAX frames of the scenes render the port's scene arrays (the
scenes themselves are held equal in tests/test_torch_surface.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.ops import lines as jlines
from software_renderer_tpu.ops import primitives2d as jp2
from software_renderer_tpu.ops.vertex import vertex_stage as jvertex_stage
from software_renderer_tpu.render import render_lines, render_points
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import lines as tlines
from software_renderer_tpu_torch.ops import primitives2d as tp2
from software_renderer_tpu_torch.ops.vertex import vertex_stage

torch.set_num_threads(1)
H, W = 64, 96
T = lambda a: torch.from_numpy(np.array(a))
ULPS = 4


def _near_integer(q):
    """q (float64): within ULPS float32 ulps of an integer."""
    spacing = np.spacing(np.abs(q).astype(np.float32)).astype(np.float64)
    return np.abs(q - np.round(q)) <= ULPS * np.maximum(spacing, 1e-30)


def _mark(near, xs, ys):
    """Mark the 3x3 pixel neighbourhoods of (xs, ys) in ``near``."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            x, y = xs + dx, ys + dy
            ok = (x >= 0) & (x < near.shape[1]) & (y >= 0) & (y < near.shape[0])
            near[y[ok], x[ok]] = True
    return near


def _near_line_samples(screen, lines, h, w):
    """Pixels a DDA sample could reach or leave by a few ulps: the
    neighbourhoods of samples whose position + 0.5 sits that close to a
    pixel boundary (positions in float64)."""
    s = max(w, h)
    a = screen[lines[:, 0]].astype(np.float64)
    b = screen[lines[:, 1]].astype(np.float64)
    d = b[:, :2] - a[:, :2]
    n = np.maximum(np.abs(d).max(-1), 1.0)
    t = np.arange(s, dtype=np.float64)[None, :]
    valid = t < n[:, None]
    px = a[:, None, 0] + d[:, None, 0] * (t / n[:, None])
    py = a[:, None, 1] + d[:, None, 1] * (t / n[:, None])
    hit = valid & (_near_integer(px + 0.5) | _near_integer(py + 0.5))
    return _mark(np.zeros((h, w), bool),
                 np.floor(px[hit] + 0.5).astype(np.int64),
                 np.floor(py[hit] + 0.5).astype(np.int64))


def assert_primitive_class(cj, ct, background, near=None, context=""):
    """Written pixels (those differing from ``background``) equal and
    colors within 1e-6, except on ``near`` pixels, at most 0.1% of the
    frame."""
    cj, ct, bg = (np.asarray(x, np.float32) for x in (cj, ct, background))
    written_j = (cj != bg).any(-1)
    written_t = (ct != bg).any(-1)
    bad = (written_j != written_t) | (np.abs(cj - ct) > 1e-6).any(-1)
    near = np.zeros(bad.shape, bool) if near is None else near
    assert written_j.any(), f"{context}: nothing written (vacuous)"
    assert not (bad & ~near).any(), (
        f"{context}: {int((bad & ~near).sum())} pixels differ away from "
        f"any rounding or edge boundary")
    assert bad.sum() <= 0.001 * bad.size, (
        f"{context}: {int(bad.sum())} boundary pixels differ")


def _background(rng, h=H, w=W):
    return rng.random((h, w, 4), dtype=np.float32)


@pytest.mark.parametrize("rgb", [False, True])
def test_scatter_points_last_writer_wins(rgb):
    """Duplicate pixels (the last entry wins), entries outside the frame
    and masked entries (dropped): bit-equal to JAX's in-order scatter."""
    rng = np.random.default_rng(1)
    h, w, k = 10, 12, 600
    img = _background(rng, h, w)
    xs = rng.integers(-3, w + 3, k).astype(np.int32)
    ys = rng.integers(-3, h + 3, k).astype(np.int32)
    colors = rng.random((k, 3 if rgb else 4), dtype=np.float32)
    mask = rng.random(k) < 0.8
    want = np.asarray(jax.jit(jlines.scatter_points)(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(colors), mask=jnp.asarray(mask)))
    got = tlines.scatter_points(T(img), T(xs), T(ys), T(colors),
                                mask=T(mask)).numpy()
    np.testing.assert_array_equal(want, got)
    # The check is not vacuous: some pixel saw several writers.
    inb = mask & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    assert np.bincount(ys[inb] * w + xs[inb]).max() > 3


def test_draw_points_matches_jax():
    rng = np.random.default_rng(2)
    img = _background(rng)
    screen = np.concatenate([rng.uniform(-10, W + 10, (400, 1)),
                             rng.uniform(-10, H + 10, (400, 1)),
                             rng.random((400, 1))], 1).astype(np.float32)
    colors = rng.random((400, 3), dtype=np.float32)
    want = jax.jit(jlines.draw_points)(jnp.asarray(img), jnp.asarray(screen),
                              jnp.asarray(colors))
    got = tlines.draw_points(T(img), T(screen), T(colors))
    assert_primitive_class(want, got.numpy(), img, context="draw_points")


def test_draw_lines_matches_jax():
    """Lines of every slope, some leaving the frame, a zero-length one,
    sharing pixels where they cross; colors interpolated along each."""
    rng = np.random.default_rng(3)
    img = _background(rng)
    n = 40
    screen = np.concatenate([rng.uniform(-20, W + 20, (n, 1)),
                             rng.uniform(-20, H + 20, (n, 1)),
                             rng.random((n, 1))], 1)
    screen = np.round(screen).astype(np.float32)   # pixel coordinates
    lines = rng.integers(0, n, (60, 2)).astype(np.int32)
    lines[0] = (3, 3)
    colors = rng.random((n, 4), dtype=np.float32)
    want = jax.jit(jlines.draw_lines)(jnp.asarray(img), jnp.asarray(screen),
                             jnp.asarray(lines), jnp.asarray(colors))
    got = tlines.draw_lines(T(img), T(screen), T(lines), T(colors))
    assert_primitive_class(want, got.numpy(), img,
                           _near_line_samples(screen, lines, H, W),
                           context="draw_lines")


def _jax_pass(rp_t):
    """The JAX RenderPass of a port line/point RenderPass's arrays."""
    m = rp_t.mesh
    mesh = sr.Mesh(positions=jnp.asarray(m.positions.numpy()),
                   indices=jnp.asarray(m.indices.numpy()),
                   colors=jnp.asarray(m.colors.numpy()))
    return sr.RenderPass(mesh=mesh, transform=jnp.asarray(
        rp_t.transform.numpy()), width=rp_t.width, height=rp_t.height,
        primitive=rp_t.primitive)


def _screens(rp, rp_t):
    """The JAX and port vertex stages' pixel coordinates, equal (NDC z,
    which the primitives do not read, within the contraction class)."""
    sj = np.asarray(jax.jit(jvertex_stage, static_argnums=(2, 3))(
        rp.mesh.positions, rp.transform, rp.width, rp.height)[0])
    st = vertex_stage(rp_t.mesh.positions, rp_t.transform, rp_t.width,
                      rp_t.height)[0].numpy()
    np.testing.assert_array_equal(sj[:, :2], st[:, :2])
    np.testing.assert_allclose(sj[:, 2], st[:, 2], rtol=0, atol=1e-6)
    return st


def test_render_lines_wireframe_cube():
    rp_t = tscenes.wireframe_cube(0.7, width=W, height=H, device="cpu")
    rp = _jax_pass(rp_t)
    assert rp_t.primitive == "line"
    _cuda.reset_launches()
    fb = srt.render(rp_t)
    assert all(n == 0 for n in _cuda.launches.values()), _cuda.launches
    fb_j = jax.jit(render_lines)(rp)
    screen = _screens(rp, rp_t)
    assert_primitive_class(
        fb_j.color, fb.color.numpy(), np.zeros((H, W, 4)),
        _near_line_samples(screen, rp_t.mesh.lines().numpy(), H, W),
        context="wireframe cube")
    assert torch.equal(fb.depth, torch.full((H, W), float("inf")))


@pytest.mark.parametrize("primitive", ["vertices", "point"])
def test_render_points_reference_sphere(primitive):
    rp_t = tscenes.reference_sphere(0.3, width=W, height=H, device="cpu")
    rp = _jax_pass(rp_t)
    rp.primitive = "vertices"     # JAX renders both as points
    rp_t.primitive = primitive
    fb = srt.render(rp_t)
    fb_j = jax.jit(render_points)(rp)
    _screens(rp, rp_t)
    assert_primitive_class(fb_j.color, fb.color.numpy(),
                           np.zeros((H, W, 4)), context="sphere points")
    assert torch.equal(fb.depth, torch.full((H, W), float("inf")))


def _near_triangle(a, b, c):
    """Pixel centres whose edge functions sit within a few ulps of 0."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64) + 0.5
    (ax, ay), (bx, by), (cx, cy) = a, b, c
    e = [(by - cy) * (xs - cx) + (cx - bx) * (ys - cy),
         (cy - ay) * (xs - cx) + (ax - cx) * (ys - cy),
         (ay - by) * (xs - bx) + (bx - ax) * (ys - by)]
    scale = 4 * max(W, H) ** 2 * np.spacing(np.float32(1.0))
    return np.any([np.abs(x) <= ULPS * scale for x in e], axis=0)


@pytest.mark.parametrize("prim", ["rect", "circle", "line", "triangle",
                                  "triangle_colors"])
def test_primitives2d_match_jax(prim):
    rng = np.random.default_rng(4)
    img = _background(rng)
    near = None
    if prim == "rect":
        args = (7.3, 11.0, 40.5, 20.25, (1.0, 0.2, 0.0))
    elif prim == "circle":
        args = (40.0, 30.5, 17.0, (0.1, 0.2, 0.9, 0.8))
        ys, xs = np.mgrid[0:H, 0:W] + 0.5
        d = np.hypot(xs - 40.0, ys - 30.5)
        near = (np.abs(d - 19.0) < 1e-4) | (np.abs(d - 15.0) < 1e-4)
    elif prim == "line":
        args = (2.0, 60.0, 91.0, 3.0, (0.0, 1.0, 0.0))
        near = _near_line_samples(
            np.array([[2, 60, 0], [91, 3, 0]], np.float32),
            np.array([[0, 1]]), H, W)
    else:
        a, b, c = (30.0, 2.5), (3.0, 61.0), (93.5, 50.0)
        args = (a, b, c)
        if prim == "triangle_colors":
            args += (((0.2, 0.4, 0.6), (1.0, 1.0, 0.0), (0.0, 0.5, 1.0)),)
        near = _near_triangle(a, b, c)
    fn = {"rect": "draw_rect", "circle": "draw_circle", "line": "draw_line",
          "triangle": "draw_triangle2d",
          "triangle_colors": "draw_triangle2d"}[prim]
    want = jax.jit(getattr(jp2, fn), static_argnums=tuple(
        range(1, len(args) + 1)))(jnp.asarray(img), *args)
    got = getattr(tp2, fn)(T(img), *args)
    assert_primitive_class(want, got.numpy(), img, near, context=prim)
