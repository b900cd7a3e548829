"""PyTorch port, trilinear (mipmapped) texture filtering against the JAX
package: the mip chain and pyramid table, the screen-space level, the
sampler at explicit and default levels, the fused path's trilinear tail,
gradients to the texels, and ``render`` of a trilinear scene on every
backend.

The mip chain and the pyramid table are sums, one scaling and copies, so
XLA has nothing to contract in them even under ``jax.jit``: they are
compared bit for bit. The level goes through ``log2``, whose last ulp
differs between libraries, and the samples through lerps that XLA:CPU
may contract: they are compared within 2 ulps of the log and within the
FMA-contraction class (1e-6 at an integer level, 1e-5 at the default
one). Frames come from JAX ``render(..., "reference")`` and are compared
with alpha exact and color in the typed depth-tie class at JAX's own
trilinear bound, 2e-3 (tests/test_mipmap.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops import texture as jtex
from software_renderer_tpu.testing.compare import assert_tie_class_equal
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import texture as ttex

torch.set_num_threads(1)
CPU = dict(device="cpu")
T = lambda a: torch.from_numpy(np.array(a))


def _textures(data, wrap):
    """(JAX texture, port texture) of ``data``; the JAX one is handed the
    port's pyramid (held bit-equal to JAX's own by
    test_mip_chain_and_pyramid_equal_jax) rather than building it op by
    op."""
    tt = ttex.Texture(data=T(data), filter="trilinear", wrap=wrap)
    return (jtex.Texture(data=jnp.asarray(data), filter="trilinear",
                         wrap=wrap, table=jnp.asarray(tt.table.numpy()),
                         table_pack=1), tt)


def _jax_pass(rp):
    """The JAX RenderPass of a port RenderPass (on the CPU); its texture
    is handed the port's pyramid, as :func:`_textures` does."""
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    m = rp.mesh
    mesh = sr.Mesh(**{f: j(getattr(m, f)) for f in (
        "positions", "indices", "colors", "normals", "uvs")})
    light = jsh.Light(*(j(getattr(rp.light, f.name))
                        for f in dataclasses.fields(rp.light)))
    tex = jtex.Texture(data=j(rp.texture.data), filter=rp.texture.filter,
                       wrap=rp.texture.wrap, table=j(rp.texture.table),
                       table_pack=1)
    return sr.RenderPass(
        mesh=mesh, transform=j(rp.transform), light=light, texture=tex,
        flat_color=j(rp.flat_color), model=j(rp.model),
        **{f: getattr(rp, f) for f in convert.STATIC_FIELDS})


@jax.jit
def _jax_chain(d):
    return jtex._mip_chain(d)


_jax_trilinear = jax.jit(jtex.sample_texture_planes_trilinear)
_jax_planes = jax.jit(jtex.sample_texture_planes)


def _jax_pyramid(d, wrap):
    return jax.jit(lambda x: jtex._mip_table_build(
        jtex.Texture(data=x, filter="trilinear", wrap=wrap)))(d)


def _uv(rng, h, w, scale_lo=0.5, scale_hi=6.0):
    """uv planes whose screen footprint varies across the frame (the
    level spans several mip levels), with a little jitter."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    s = np.linspace(scale_lo, scale_hi, h, dtype=np.float32)[:, None] / 16.0
    u = xs * s + rng.uniform(-0.01, 0.01, (h, w)) - 0.2
    v = ys * s * 0.7 + rng.uniform(-0.01, 0.01, (h, w)) + 0.1
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_mip_chain_and_pyramid_equal_jax(wrap):
    rng = np.random.default_rng(1)
    for shape in ((32, 16, 3), (15, 16, 4)):
        data = rng.random(shape, dtype=np.float32)
        th, tw = shape[:2]
        n = jtex._num_mip_levels(th, tw)
        assert ttex._num_mip_levels(th, tw) == n
        assert ttex._mip_offsets(th, tw, n) == jtex._mip_offsets(th, tw, n)
        for a, b in zip(_jax_chain(jnp.asarray(data)),
                        ttex._mip_chain(T(data)), strict=True):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        tt = ttex.Texture(data=T(data), filter="trilinear", wrap=wrap)
        np.testing.assert_array_equal(
            np.asarray(_jax_pyramid(jnp.asarray(data), wrap)),
            tt.table.numpy())


def test_screen_lod_within_two_ulps_of_jax():
    rng = np.random.default_rng(2)
    u, v = _uv(rng, 24, 40)
    a = np.asarray(jax.jit(jtex.screen_lod, static_argnums=(2, 3))(
        jnp.asarray(u), jnp.asarray(v), 64, 32))
    b = ttex.screen_lod(T(u), T(v), 64, 32).numpy()
    assert np.isfinite(b).all() and np.ptp(b) > 2.0  # several levels
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= 2 * ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_integer_lod_matches_jax(wrap):
    """At an integer level: within the FMA-contraction class (1e-6), and
    the port's sample equals its own bilinear sample of that level bit
    for bit (the blend adds (b - a) * 0)."""
    rng = np.random.default_rng(3)
    data = rng.random((32, 16, 3), dtype=np.float32)
    tj, tt = _textures(data, wrap)
    u, v = _uv(rng, 8, 12)
    for k in (0, 1, 2, 4):
        a = _jax_trilinear(tj, jnp.asarray(u), jnp.asarray(v),
                           jnp.float32(k))
        b = ttex.sample_texture_planes_trilinear(tt, T(u), T(v), lod=float(k))
        bil = ttex.Texture(data=ttex._mip_chain(T(data))[k],
                           filter="bilinear", wrap=wrap)
        for x, y, z in zip(a, b, ttex.sample_texture_planes(bil, T(u), T(v)),
                           strict=True):
            np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0,
                                       atol=1e-6)
            assert torch.equal(y, z)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_default_lod_matches_jax(wrap):
    rng = np.random.default_rng(4)
    data = rng.random((64, 32, 3), dtype=np.float32)
    tj, tt = _textures(data, wrap)
    u, v = _uv(rng, 24, 40)
    a = _jax_planes(tj, jnp.asarray(u), jnp.asarray(v))
    b = ttex.sample_texture_planes(tt, T(u), T(v))
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0,
                                   atol=1e-5)
    # The port's sample_texture on an [H, W, 2] grid is its planes
    # sampler (as JAX's is).
    uv = np.stack([u, v], -1)
    np.testing.assert_allclose(
        np.stack([np.asarray(x) for x in a], -1),
        ttex.sample_texture(tt, T(uv)).numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="trilinear"):
        ttex.sample_texture(tt, T(uv.reshape(-1, 2)))


def test_compacted_tail_equals_plain_sampler():
    """The fused path's trilinear tail equals the plain sampler on every
    covered pixel (it samples the whole frame)."""
    rng = np.random.default_rng(5)
    tt = ttex.Texture(data=T(rng.random((64, 64, 3), dtype=np.float32)),
                      filter="trilinear")
    u, v = _uv(rng, 16, 256)
    cov = rng.random((16, 256)) < 0.3
    got = ttex.sample_texture_planes_trilinear_compacted(tt, T(u), T(v),
                                                         T(cov))
    want = ttex.sample_texture_planes_trilinear(tt, T(u), T(v))
    for g, w_ in zip(got, want, strict=True):
        assert torch.equal(g[T(cov)], w_[T(cov)])


def test_gradients_to_texels_match_jax():
    rng = np.random.default_rng(6)
    data = rng.random((16, 16, 3), dtype=np.float32)
    u, v = _uv(rng, 12, 20, 1.0, 4.0)
    wts = rng.random((3, 12, 20), dtype=np.float32)

    def jloss(d):
        out = jtex.sample_texture_planes(
            jtex.Texture(data=d, filter="trilinear"), jnp.asarray(u),
            jnp.asarray(v))
        return sum(jnp.sum(o * wts[i]) for i, o in enumerate(out))

    gj = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(data)))
    d = T(data).requires_grad_(True)
    out = ttex.sample_texture_planes(ttex.Texture(data=d, filter="trilinear"),
                                     T(u), T(v))
    sum((o * T(wts[i])).sum() for i, o in enumerate(out)).backward()
    assert np.abs(gj).sum() > 0
    np.testing.assert_allclose(gj, d.grad.numpy(), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def trilinear_scene():
    """Config 2 at 128x64 with its texture trilinear, and JAX's reference
    frame of it (:func:`_jax_pass`)."""
    rp = tscenes.config2_textured_cube(0.4, width=128, height=64, **CPU)
    rp.texture = ttex.Texture(data=rp.texture.data, filter="trilinear",
                              wrap=rp.texture.wrap)
    return rp, sr.render(_jax_pass(rp), backend="reference")


@pytest.mark.parametrize("backend", ["auto", "pallas", "reference"])
def test_render_trilinear_matches_jax(trilinear_scene, backend):
    rp_t, fb_j = trilinear_scene
    _cuda.reset_launches()
    fb_t = srt.render(rp_t, backend=backend)
    assert all(n == 0 for n in _cuda.launches.values()), _cuda.launches
    cj, dj = np.asarray(fb_j.color), np.asarray(fb_j.depth)
    ct, dt = fb_t.color.numpy(), fb_t.depth.numpy()
    assert np.isfinite(ct).all() and ct[..., 3].any()
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt, atol=2e-3,
                           context=f"trilinear {backend}")
