"""PyTorch port, the texture slice: the windowed sampler's index prep and
plain version (ops/texture_kernel.py), the routed texture tail
(``SR_TEX_WINDOWED``) and which frames take the tail kernel
(ops/shading.py ``tail_kernel_plan``; finish_fused, its plain version,
against the kernel's arithmetic in numpy), the geometry-gradient
contract of ``render``,
texture training (parallel/sharding.py) and the gather probe's plain
versions, against the JAX package.

Inputs come from numpy generators with fixed seeds. The JAX side is
always XLA (no Pallas interpret mode): ``_xla_equivalent`` is the JAX
kernel's own differentiable twin. Uncovered lanes carry garbage UVs, as
in tests/test_texture_kernel.py; a float-to-int cast of them is
undefined, so per-lane values are compared on covered lanes only. Sampled
values are held within ``ULP`` (JAX's class for lerps of exact texels);
gradients, which sum many lanes in another order, within 1e-5 relative.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.ops import texture as jtex
from software_renderer_tpu.ops import texture_kernel as jtk
from software_renderer_tpu.ops.rasterize_ref import (
    visibility_ref as jvisibility_ref)
from software_renderer_tpu.parallel.sharding import (
    make_mesh, texture_train_step as jtexture_train_step)
from software_renderer_tpu.testing.compare import assert_tie_class_equal
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops import texture_kernel as ttk
from software_renderer_tpu_torch.ops.rasterize_ref import visibility_ref
from software_renderer_tpu_torch.parallel.batch import (animation_transforms,
                                                        render_batch)
from software_renderer_tpu_torch.parallel.sharding import texture_train_step
from software_renderer_tpu_torch.render import planar_front_of
from software_renderer_tpu_torch.tools import probe_dyngather as probe

torch.set_num_threads(1)
ULP = 1e-6


def _case(seed, cap, th=256, tw=256, c=3, cover_p=0.8):
    """Texture and [cap, 128] UV planes as JAX's test draws them: most
    segments clustered in v, some spread, v wrapping over the seam, and
    garbage UVs on uncovered lanes; segment 0 is wholly uncovered when
    ``cover_p`` < 1."""
    rng = np.random.default_rng(seed)
    data = rng.random((th, tw, c)).astype(np.float32)
    v0 = rng.uniform(0, 1, size=(cap, 1))
    spread = rng.choice([0.01, 0.08, 0.9], size=(cap, 1), p=[0.7, 0.2, 0.1])
    v = (v0 + rng.uniform(0, 1, size=(cap, 128)) * spread) % 1.0
    u = rng.uniform(0, 1, size=(cap, 128))
    cov = rng.random((cap, 128)) < cover_p
    cov[0] &= cover_p >= 1
    u = np.where(cov, u, 1e30).astype(np.float32)
    v = np.where(cov, v, -3e7).astype(np.float32)
    return data, u, v, cov


@functools.lru_cache(maxsize=None)
def _jax_prep(th, tw, wrap):
    return jax.jit(functools.partial(jtk.windowed_prep, th=th, tw=tw,
                                     wrap=wrap))


@functools.lru_cache(maxsize=None)
def _jax_count(th, wrap):
    return jax.jit(functools.partial(jtk.windowed_count, th=th, wrap=wrap))


@functools.partial(jax.jit, static_argnames=("th", "tw", "wrap"))
def _jax_sample(data, u, v, cov, *, th, tw, wrap):
    """JAX's prep, ``_xla_equivalent`` on its outputs, and the quad-table
    sampler, in one compiled program."""
    xa, dy, fx, fy, y0, _ = jtk.windowed_prep(u, v, cov, th=th, tw=tw,
                                              wrap=wrap)
    xla = jtk._xla_equivalent(jtk.windowed_tables(data, wrap), xa, dy, fx,
                              fy, y0, th=th, tw=tw, wrap=wrap)
    planes = jtex.sample_texture_planes(jtex.Texture(data=data, wrap=wrap),
                                        u, v)
    return jnp.stack(xla), jnp.stack(planes)


@functools.partial(jax.jit, static_argnames=("th", "tw", "wrap"))
def _jax_sampler_vjp(data, u, v, cov, cot, *, th, tw, wrap):
    """jax.vjp of ``_xla_equivalent`` in the tables, fx and fy."""
    xa, dy, fx, fy, y0, _ = jtk.windowed_prep(u, v, cov, th=th, tw=tw,
                                              wrap=wrap)
    _, vjp = jax.vjp(
        lambda tabs, fx, fy: jtk._xla_equivalent(
            tabs, xa, dy, fx, fy, y0, th=th, tw=tw, wrap=wrap),
        jtk.windowed_tables(data, wrap), fx, fy)
    g_tab, g_fx, g_fy = vjp(list(cot))
    return jnp.stack(g_tab), g_fx, g_fy


def _port_prep(u, v, cov, th, tw, wrap):
    return ttk.windowed_prep(torch.from_numpy(u), torch.from_numpy(v),
                             torch.from_numpy(cov), th=th, tw=tw, wrap=wrap)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_windowed_prep_count_tables_match_jax(wrap):
    th = tw = 256
    data, u, v, cov = _case(3, 48)
    jp = [np.asarray(a) for a in _jax_prep(th, tw, wrap)(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(cov))]
    tp = [a.numpy() for a in _port_prep(u, v, cov, th, tw, wrap)]
    for name, a, b in zip(("xa", "dy", "fx", "fy"), jp[:4], tp[:4]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a[cov], b[cov], err_msg=name)
    np.testing.assert_array_equal(jp[4], tp[4], err_msg="y0")
    np.testing.assert_array_equal(jp[5], tp[5], err_msg="nwin")
    assert tp[5][0] == 0 and (tp[5][1:] > 0).all() and tp[5].max() > 2
    count = ttk.windowed_count(torch.from_numpy(v), torch.from_numpy(cov),
                               th=th, wrap=wrap).numpy()
    np.testing.assert_array_equal(count, tp[5])
    np.testing.assert_array_equal(
        count, np.asarray(_jax_count(th, wrap)(jnp.asarray(v),
                                                jnp.asarray(cov))))
    np.testing.assert_array_equal(
        np.stack(jtk.windowed_tables(jnp.asarray(data), wrap)),
        ttk.windowed_tables(torch.from_numpy(data), wrap).numpy())


def test_windowed_prep_seam_aware_base():
    """JAX's seam case: a ``repeat`` segment whose texel rows alternate
    250..255 and 0..5 gets the base 248 and 2 windows, not th/8."""
    th = tw = 256
    rows = np.where(np.arange(128) % 2 == 0, 250 + np.arange(128) % 6,
                    np.arange(128) % 6)
    v = ((rows + 0.5) / th).astype(np.float32)[None, :]
    u = np.full((1, 128), 0.5, np.float32)
    cov = np.ones((1, 128), bool)
    _, dy, _, _, y0, nwin = _port_prep(u, v, cov, th, tw, "repeat")
    _, _, _, _, jy0, jnwin = _jax_prep(th, tw, "repeat")(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(cov))
    assert int(y0[0]) == int(jy0[0]) == 248
    assert int(nwin[0]) == int(jnwin[0]) == 2
    assert int(dy.max()) < 2 * ttk.WIN_STRIDE
    assert int(ttk.windowed_count(torch.from_numpy(v),
                                  torch.from_numpy(cov), th=th,
                                  wrap="repeat")[0]) == 2
    nwin0 = _port_prep(u, v, ~cov, th, tw, "repeat")[5]
    assert int(nwin0[0]) == 0


def test_windowed_supported_matches_jax():
    cases = [(256, 100, 3, 128), (100, 256, 3, 128), (256, 256, 3, 64),
             (1024, 1024, 4, 128), (256, 256, 3, 128), (128, 128, 1, 128),
             (64, 512, 3, 128), (8, 640, 1, 128), (256, 256, 5, 128)]
    for case in cases:
        assert ttk.windowed_supported(*case) == jtk.windowed_supported(
            *case), case


@pytest.mark.parametrize("th,tw,c,wrap", [(128, 128, 1, "repeat"),
                                          (64, 512, 3, "repeat"),
                                          (256, 256, 4, "clamp")])
def test_plain_sampler_matches_jax(th, tw, c, wrap):
    data, u, v, cov = _case(5, 32, th=th, tw=tw, c=c)
    xla, planes = (np.asarray(a) for a in _jax_sample(
        *map(jnp.asarray, (data, u, v, cov)), th=th, tw=tw, wrap=wrap))
    xa, dy, fx, fy, y0, nwin = _port_prep(u, v, cov, th, tw, wrap)
    got = ttk.sample_segments_windowed(
        ttk.windowed_texels(torch.from_numpy(data), wrap), xa, dy, fx, fy,
        y0, nwin, c=c, th=th, tw=tw, wrap=wrap).numpy()
    inside = ((dy >= 0) & (dy < ttk.WIN_STRIDE * nwin[:, None])).numpy()
    assert inside[cov].all() and not inside.all()
    for ch in range(c):
        np.testing.assert_allclose(got[ch][cov], xla[ch][cov], atol=ULP)
        np.testing.assert_allclose(got[ch][cov], planes[ch][cov], atol=ULP)
        assert (got[ch][~inside] == 0).all()


def test_plain_sampler_grads_match_jax_vjp():
    """Every lane covered, spread and seam segments included: the plain
    version's gradients in the tables, fx and fy against jax.vjp of
    ``_xla_equivalent``."""
    th, tw, c, wrap = 128, 128, 2, "repeat"
    data, u, v, cov = _case(7, 16, th=th, tw=tw, c=c, cover_p=1.0)
    rng = np.random.default_rng(8)
    cot = rng.standard_normal((c, 16, 128)).astype(np.float32)
    jg_tab, jg_fx, jg_fy = _jax_sampler_vjp(
        *map(jnp.asarray, (data, u, v, cov, cot)), th=th, tw=tw, wrap=wrap)
    xa, dy, fx, fy, y0, nwin = _port_prep(u, v, cov, th, tw, wrap)
    tabs = ttk.windowed_tables(torch.from_numpy(data), wrap)
    tabs.requires_grad_(True)
    fx.requires_grad_(True)
    fy.requires_grad_(True)
    out = ttk.sample_segments_windowed_plain(tabs, xa, dy, fx, fy, y0,
                                             nwin, th=th, tw=tw, wrap=wrap)
    g_tab, g_fx, g_fy = torch.autograd.grad(out, (tabs, fx, fy),
                                            torch.from_numpy(cot))
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(jg_tab), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_fx.numpy(), np.asarray(jg_fx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g_fy.numpy(), np.asarray(jg_fy), rtol=1e-5,
                               atol=1e-6)


def test_sampler_function_backward_matches_plain(monkeypatch):
    """The card's autograd Function (its forward pointed at the plain
    version here) differentiates only the lanes inside a window with a
    nonzero cotangent (here the covered ones, as through finish_fused);
    its gradients equal autograd through the plain version on every
    lane."""
    th, tw, c, wrap = 128, 128, 3, "repeat"
    data, u, v, cov = _case(9, 16, th=th, tw=tw, c=c)
    xa, dy, fx, fy, y0, nwin = _port_prep(u, v, cov, th, tw, wrap)
    texels = ttk.windowed_texels(torch.from_numpy(data), wrap)
    cot = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (c, 16, 128)).astype(np.float32)) * torch.from_numpy(cov)
    monkeypatch.setattr(ttk, "sampler_kernel", ttk.sampler_plain)
    grads = []
    for fn in (lambda *a: ttk._WindowedSampler.apply(
                   a[0], a[3], a[4], a[1], a[2], a[5], a[6], c, th, tw,
                   wrap),
               functools.partial(ttk.sampler_plain, c=c, th=th, tw=tw,
                                 wrap=wrap)):
        args = [t.clone().requires_grad_(True) for t in (texels, fx, fy)]
        out = fn(args[0], xa, dy, args[1], args[2], y0, nwin)
        grads.append(torch.autograd.grad(out, args, cot))
    for gk, gp in zip(*grads):
        torch.testing.assert_close(gk, gp, rtol=1e-6, atol=1e-6)
    assert grads[0][1].abs().sum() > 0


def _jax_scene(name):
    if name == "config2":
        return jscenes.config2_textured_cube(0.7, width=128, height=128)
    return jscenes.config4_many_objects(0.0, width=256, height=128,
                                        triangles=3000)


def _port_of(rp):
    return convert.render_pass_from_numpy(
        convert.arrays_of(rp), device="cpu", **convert.static_fields_of(rp))


@pytest.mark.parametrize("name", ["config2", "config4"])
def test_render_windowed_modes_match_jax(name, monkeypatch):
    """Modes "1" and "adaptive" give mode "0"'s frame bit for bit on the
    CPU (the plain versions sample the same texels with the same lerp),
    and all match JAX's reference backend."""
    rp_j = _jax_scene(name)
    rp = _port_of(rp_j)
    calls = []
    spy = lambda *a, **k: calls.append(1) or ttk.sample_segments_windowed(
        *a, **k)
    monkeypatch.setattr(ttex, "sample_segments_windowed", spy)
    frames = {}
    # Adaptive under a budget nothing exceeds and one every covered frame
    # exceeds: the windowed and the quad-table route.
    runs = (("0", 4.0, 0), ("1", 4.0, 1), ("adaptive", 1e9, 1),
            ("adaptive", 0.0, 0))
    for mode, budget, windowed in runs:
        monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
        monkeypatch.setattr(ttex, "TEX_WIN_AVG_BUDGET", budget)
        calls.clear()
        frames[mode, budget] = srt.render(rp)
        assert len(calls) == windowed, (mode, budget)
    fb_j = sr.render(rp_j, backend="reference")
    cj, dj = np.asarray(fb_j.color), np.asarray(fb_j.depth)
    first = frames["0", 4.0]
    assert first.color[..., 3].any()
    for (mode, _), fb in frames.items():
        torch.testing.assert_close(fb.color, first.color, rtol=0, atol=0)
        torch.testing.assert_close(fb.depth, first.depth, rtol=0, atol=0)
        np.testing.assert_array_equal(cj[..., 3], fb.color[..., 3].numpy())
        assert_tie_class_equal(cj, fb.color.numpy(), dj, fb.depth.numpy(),
                               atol=1e-3, context=f"{name} mode {mode}")


@jax.jit
def _jax_ids(rp):
    """Triangle ids of JAX's reference visibility pass."""
    ps = jfe.planar_front(jfe.corner_cols(rp.mesh.positions[
        rp.mesh.triangles()]), rp.transform, rp.width, rp.height,
        cull_backfaces=rp.cull_backfaces, pallas=False)
    return jvisibility_ref(jfe.to_setup(ps), width=rp.width,
                           height=rp.height)[1]


def test_texture_train_step_matches_jax(monkeypatch):
    """One step from a flat 0.5 texture at config 2 (128x128, 2 frames):
    JAX's texture_train_step on the reference backend against the port's
    on reference and on auto in both sampler modes. The frames are two
    of the scene's times whose triangle ids agree exactly between the
    packages (at other times a few depth ties on a face diagonal flip,
    the typed tie class); then the loss (rtol 1e-5: float32 sums in other
    orders) and the new texture at lr 5000, where the step moves texels
    by up to ~0.02: within 1e-6 on reference, 1e-5 on auto, whose planes
    differ from barycentric interpolation by ulps that the step scales
    (color within 2e-5 of JAX's reference, tests/test_torch_render.py)."""
    rps_j = [jscenes.config2_textured_cube(t, width=128, height=128)
             for t in (0.1, 1.1)]
    rp_j, rp = rps_j[0], _port_of(rps_j[0])
    for r in rps_j:
        np.testing.assert_array_equal(
            np.asarray(_jax_ids(r)),
            visibility_ref(tfe.to_setup(planar_front_of(_port_of(r))),
                           width=128, height=128)[1].numpy())
    ts_j = jnp.stack([r.transform for r in rps_j])
    targets_j = jnp.stack([sr.render(dataclasses.replace(
        rp_j, transform=t), backend="reference").color for t in ts_j])
    ts = torch.from_numpy(np.array(ts_j))
    targets = torch.from_numpy(np.array(targets_j))
    torch.testing.assert_close(render_batch(rp, ts, backend="reference")
                               .color, targets, rtol=0, atol=1e-5)
    tex0 = np.full(rp_j.texture.data.shape, 0.5, np.float32)
    lr = 5000.0
    mesh = make_mesh(1, 1, jax.devices()[:1])
    jnew, jloss = jtexture_train_step(jnp.asarray(tex0), rp_j, ts_j,
                                      targets_j, mesh, lr=lr,
                                      backend="reference")
    jnew = np.asarray(jnew)
    assert np.abs(jnew - tex0).max() > 1e-2
    for backend, mode in (("reference", "0"), ("auto", "0"),
                          ("auto", "1")):
        monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
        new, loss = texture_train_step(torch.from_numpy(tex0), rp, ts,
                                       targets, lr=lr, backend=backend)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(
            new.numpy(), jnew, rtol=0,
            atol=1e-6 if backend == "reference" else 1e-5,
            err_msg=f"{backend} mode {mode}")


def _with_grad(rp, what):
    """``rp`` with one leaf replaced by a copy that requires grad."""
    if what == "positions":
        leaf = rp.mesh.positions.clone().requires_grad_(True)
        return dataclasses.replace(rp, mesh=dataclasses.replace(
            rp.mesh, positions=leaf)), leaf
    if what == "light":
        leaf = rp.light.color.clone().requires_grad_(True)
        return dataclasses.replace(rp, light=dataclasses.replace(
            rp.light, color=leaf)), leaf
    leaf = rp.texture.data.clone().requires_grad_(True)
    return dataclasses.replace(rp, texture=srt.Texture(data=leaf)), leaf


@pytest.mark.parametrize("shading", ["textured", "flat"])
def test_geometry_grads_warn_and_zero(shading):
    """render(backend="auto") returns zero gradients with JAX's warning
    for geometry and light inputs, and texture gradients without one. A
    flat frame's color depends on coverage alone, so there the loss is
    its depth."""
    rp = dataclasses.replace(tscenes.config2_textured_cube(
        0.7, width=64, height=64, device="cpu"), shading=shading)

    def loss(fb):
        if shading == "flat":
            return fb.depth[torch.isfinite(fb.depth)].sum()
        return fb.color.sum()

    for what in ("positions", "light")[:2 if shading == "textured" else 1]:
        r, leaf = _with_grad(rp, what)
        with pytest.warns(UserWarning, match="fused pipeline stops"):
            g, = torch.autograd.grad(loss(srt.render(r)), leaf)
        assert g.shape == leaf.shape and not g.any(), what
    if shading == "textured":
        r, leaf = _with_grad(rp, "texture")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            g, = torch.autograd.grad(loss(srt.render(r)), leaf)
        assert g.abs().sum() > 0


def test_render_batch_and_animation_transforms():
    rp = tscenes.config1_flat_cube(0.3, width=64, height=48, device="cpu")
    ts = animation_transforms(lambda t: rp.transform * (1.0 + t),
                              [0.0, 0.1])
    assert ts.shape == (2, 4, 4)
    fb = render_batch(rp, ts)
    assert fb.color.shape == (2, 48, 64, 4) and fb.depth.shape == (2, 48, 64)
    for i in range(2):
        one = srt.render(dataclasses.replace(rp, transform=ts[i]))
        torch.testing.assert_close(fb.color[i], one.color, rtol=0, atol=0)


def test_probe_plain_versions_match_numpy():
    res = probe.run(device="cpu")
    assert [s[:3] for s in res["shapes"]] == list(probe.SHAPES)
    assert all(s[3] for s in res["shapes"]) and res["lookup_exact"]
    assert res["lookup_ms"] is None and res["row_gather_ms"] is None
    rng = np.random.default_rng(1)
    x = rng.random((16, 256)).astype(np.float32)
    idx = rng.integers(0, 256, size=(16, 256)).astype(np.int32)
    np.testing.assert_array_equal(
        probe.take_along_axis(torch.from_numpy(x), torch.from_numpy(idx), 1)
        .numpy(), np.take_along_axis(x, idx.astype(np.int64), 1))
    tab, y0, ty, tx, _, _ = probe.lookup_inputs(rng, "cpu")
    assert ((ty >= y0[:, None]) & (ty < y0[:, None] + probe.WIN)).all()
    np.testing.assert_array_equal(
        probe.window_lookup(tab, y0, ty, tx).numpy(),
        tab.numpy()[ty.numpy(), tx.numpy()])


# ---------------------------------------------------------------------------
# The texture tail: which frames take the tail kernel (csrc/tail.cu) and
# finish_fused, its plain version, on the CPU.
# ---------------------------------------------------------------------------

_TAIL_CHANS = {"lit_spec_uv": [("lit", 3), ("spec", 1), ("uv", 2)],
               "rgb_uv": [("rgb", 3), ("uv", 2)],
               "final": [("final", 3)], "rgb": [("rgb", 3)]}


def _tail_inputs(plan="lit_spec_uv", c=3, wrap="repeat", h=19, w=37,
                 filter="bilinear", seed=3):
    """CPU fused output planes of ``plan`` (u and v in [-2.5, 3.5), ~30%
    of pixels uncovered), the [h, w] ids, the default light and a random
    24x16 texture of ``c`` channels."""
    g = torch.Generator().manual_seed(seed)
    chans = _TAIL_CHANS[plan]
    out = torch.rand((sum(s for _, s in chans), h, w), generator=g)
    if "uv" in dict(chans):
        out[-2:] = out[-2:] * 6.0 - 2.5
    tid = torch.randint(0, 500, (h, w), generator=g, dtype=torch.int32)
    tid[torch.rand((h, w), generator=g) < 0.3] = -1
    tex = ttex.Texture(data=torch.rand((16, 24, c), generator=g),
                       filter=filter, wrap=wrap)
    return out, tid, chans, tsh.Light.default("cpu"), tex


def _tail_numpy(out, tid, chans, light, tex):
    """The tail kernel's arithmetic per pixel in numpy float32: x = u * tw
    - 0.5, floor, fraction, truncation to int32, torch.remainder or
    clamp, one quad-table row, sample_texture_planes' lerps, colour times
    texture, plus specular times spec, masked, alpha 1 where covered."""
    f32 = np.float32
    names = [n for n, _ in chans]
    p = out.numpy()
    rgb = [p[0], p[1], p[2]]
    if "uv" in names:
        th, tw, c = tex.data.shape
        uo = 4 if "spec" in names else 3
        x = p[uo] * f32(tw) - f32(0.5)
        y = p[uo + 1] * f32(th) - f32(0.5)
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        xi, yi = x0.astype(np.int32), y0.astype(np.int32)
        if tex.wrap == "repeat":
            xa, ya = np.mod(xi, tw), np.mod(yi, th)
        else:
            xa, ya = np.clip(xi, 0, tw - 1), np.clip(yi, 0, th - 1)
        q = tex.table.numpy()[ya * tw + xa]
        samples = []
        for ch in range(min(c, 3)):
            t00, t01 = q[..., ch], q[..., c + ch]
            t10, t11 = q[..., 2 * c + ch], q[..., 3 * c + ch]
            top = t00 + (t01 - t00) * fx
            bot = t10 + (t11 - t10) * fx
            samples.append(top + (bot - top) * fy)
        rgb = [rgb[ch] * samples[ch if c > 1 else 0] for ch in range(3)]
        if "spec" in names:
            ks = light.specular.numpy()
            rgb = [rgb[ch] + ks[ch] * p[3] for ch in range(3)]
    cov = tid.numpy() != -1
    res = np.zeros(cov.shape + (4,), np.float32)
    res[cov, :3] = np.stack(rgb, -1)[cov]
    res[cov, 3] = 1.0
    return res


@pytest.mark.parametrize("plan,c,wrap", [
    (p, c, wrap) for p in ("lit_spec_uv", "rgb_uv") for c in (1, 3, 4)
    for wrap in ("repeat", "clamp")] + [("final", 3, "repeat"),
                                        ("rgb", 3, "repeat")])
def test_finish_fused_on_cpu_equals_the_tail_arithmetic(plan, c, wrap):
    """finish_fused on the CPU is what it was: bit for bit the per-pixel
    arithmetic that the tail kernel repeats (numpy float32, one rounding
    per operation), on every plan the kernel serves, textures of 1, 3 and
    4 channels, both wraps and u, v outside [0, 1]; and texture_tail on
    CPU tensors is finish_fused."""
    out, tid, chans, light, tex = _tail_inputs(plan, c, wrap)
    want = _tail_numpy(out, tid, chans, light, tex)
    got = tsh.finish_fused(out, tid != -1, out_chans=chans, light=light,
                           texture=tex)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    routed = tsh.texture_tail(out, tid, out_chans=chans, light=light,
                              texture=tex)
    assert torch.equal(routed, got)


def _grad_case(what):
    out, tid, chans, light, tex = _tail_inputs()
    if what == "out":
        out.requires_grad_(True)
    elif what == "texture":
        tex = ttex.Texture(data=tex.data.clone().requires_grad_(True))
    else:
        light = dataclasses.replace(
            light, specular=light.specular.clone().requires_grad_(True))
    return out, chans, light, tex


@pytest.mark.parametrize("case,want", [
    ("lit_spec_uv", 2), ("rgb_uv", 1), ("final", 0), ("rgb", 0),
    ("single_channel", 2), ("four_channels", 2), ("clamp", 2),
    ("trilinear", None), ("nearest", None), ("route1", None),
    ("adaptive", None), ("two_channels", None), ("five_channels", None),
    ("uv_without_texture", None), ("spec_without_light", None),
    ("other_plan", None), ("grad_out", None), ("grad_texture", None),
    ("grad_specular", None), ("grad_texture_no_grad_mode", 2)])
def test_tail_kernel_plan_picks_the_path(case, want, monkeypatch):
    """tail_kernel_plan sends each frame where it belongs: every plan of
    TAIL_PLANS on a bilinear texture of 1, 3 or 4 channels, either wrap,
    route "0", with no gradient needed, to the kernel; other filters,
    routes, channel counts and plans, and a gradient through the tail's
    inputs, to finish_fused (under no_grad the gradient is not needed).
    The plan does not read the device: texture_tail asks for CUDA."""
    plan = case if case in _TAIL_CHANS else "lit_spec_uv"
    c = {"single_channel": 1, "four_channels": 4, "two_channels": 2,
         "five_channels": 5}.get(case, 3)
    filt = case if case in ("trilinear", "nearest") else "bilinear"
    out, _, chans, light, tex = _tail_inputs(
        plan, c, "clamp" if case == "clamp" else "repeat", filter=filt)
    if case in ("route1", "adaptive"):
        monkeypatch.setattr(ttex, "TEX_WINDOWED",
                            "1" if case == "route1" else "adaptive")
    if case == "uv_without_texture":
        tex = None
    if case == "spec_without_light":
        light = None
    if case == "other_plan":
        chans = [("lit", 3), ("uv", 2)]
    if case.startswith("grad"):
        out, chans, light, tex = _grad_case(
            case.split("_")[1] if case != "grad_texture_no_grad_mode"
            else "texture")
    if case == "grad_texture_no_grad_mode":
        with torch.no_grad():
            assert tsh.tail_kernel_plan(out, chans, light, tex) == want
        assert tsh.tail_kernel_plan(out, chans, light, tex) is None
        return
    assert tsh.tail_kernel_plan(out, chans, light, tex) == want


def test_texture_tail_on_cpu_never_launches(monkeypatch):
    """CPU tensors take finish_fused whatever their plan: texture_tail
    does not call the kernel's wrapper, and render on the CPU keeps its
    frame."""
    def boom(*a, **kw):
        raise AssertionError("the tail kernel was called on CPU tensors")

    monkeypatch.setattr(tsh, "tail_kernel", boom)
    out, tid, chans, light, tex = _tail_inputs()
    assert tsh.tail_kernel_plan(out, chans, light, tex) == 2
    got = tsh.texture_tail(out, tid, out_chans=chans, light=light,
                           texture=tex)
    assert torch.equal(got, tsh.finish_fused(
        out, tid != -1, out_chans=chans, light=light, texture=tex))
    rp = tscenes.config2_textured_cube(0.7, width=48, height=40,
                                       device="cpu")
    fb = srt.render(rp)
    assert bool(fb.color[..., 3].any())
