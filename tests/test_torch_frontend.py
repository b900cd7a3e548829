"""PyTorch port, front-end: planar_front, the stream table and the raster
records against the JAX package on the same scenes (inputs made with
numpy from seeds and fed to both packages).

Tolerances: coverage-critical columns (edge gradients, bbox, valid,
areas, clip w) bit-exact; edge constants and the depth plane within the
FMA-contraction class of testing/compare.py (XLA:CPU may contract a
multiply-add that torch rounds twice); repacked raster columns bit-exact.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.ops.vertex import round_half_away as jround_half_away
from software_renderer_tpu.testing.compare import assert_fe_contraction_class
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops.frontend_kernel import fe_kernel, fe_plain
from software_renderer_tpu_torch.ops.vertex import round_half_away

torch.set_num_threads(1)


def _random_scene(n=97, seed=0, w=160, h=120):
    rng = np.random.default_rng(seed)
    corners = rng.uniform(-1.2, 1.2, size=(n, 3, 3)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[3, 2] = 1.0  # w = z + 1
    return corners, m, w, h


def _numpy_fields(ps):
    return type("PS", (), {f.name: getattr(ps, f.name).numpy()
                           for f in dataclasses.fields(ps)})


def _both_fronts(seed, cull):
    corners, m, w, h = _random_scene(seed=seed)
    ps_j = jfe.planar_front(jfe.corner_cols(jnp.asarray(corners)),
                            jnp.asarray(m), w, h, cull_backfaces=cull,
                            pallas=False)
    ps_t = tfe.planar_front(tfe.corner_cols(torch.from_numpy(corners)),
                            torch.from_numpy(m), w, h, cull_backfaces=cull)
    return ps_j, ps_t, corners, m, w, h


@pytest.mark.parametrize("cull", [False, True])
def test_planar_front_matches_jax(cull):
    ps_j, ps_t, corners, m, w, h = _both_fronts(0, cull)
    assert ps_t.num_triangles == 97
    assert bool(ps_t.valid.any()) and not bool(ps_t.valid.all())
    assert_fe_contraction_class(ps_j, _numpy_fields(ps_t), corners, m,
                                width=w, height=h,
                                context=f"torch planar_front cull={cull}")


def test_fe_plain_rows_are_planar_setup_columns():
    corners, m, w, h = _random_scene(seed=4)
    cols = torch.from_numpy(corners.transpose(1, 2, 0).reshape(9, -1).copy())
    rows = fe_plain(cols, torch.from_numpy(m).reshape(16), w, h)
    ps = tfe.planar_setup_from_rows(rows)
    assert rows.shape == (len(tfe.FE_ROWS), 97)
    assert ps.bx0.dtype == torch.int32 and ps.valid.dtype == torch.bool
    ref = tfe.planar_front(tfe.corner_cols(torch.from_numpy(corners)),
                           torch.from_numpy(m), w, h)
    for f in dataclasses.fields(ps):  # NaN == NaN for assert_array_equal
        np.testing.assert_array_equal(getattr(ps, f.name).numpy(),
                                      getattr(ref, f.name).numpy(),
                                      err_msg=f.name)


def test_round_half_away():
    x = np.array([0.5, -0.5, 1.5, -2.5, 0.49999997, -0.49999997, 2.4, 0.0],
                 np.float32)
    got = round_half_away(torch.from_numpy(x)).numpy()
    # 0.49999997 + 0.5 rounds to 1.0 in float32, so the formula gives 1
    # there where CUDA's roundf gives 0: the port keeps the formula.
    np.testing.assert_array_equal(
        got, np.array([1, -1, 2, -3, 1, -1, 2, 0], np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(jround_half_away(jnp.asarray(x))))


def test_stream_table_and_records_match_jax():
    """One shared PlanarSetup into both packages: the raster columns of
    the stream table and the packed records are pure repacks (bit-equal);
    the attribute planes are multiply-add chains (contraction class)."""
    ps_j, _, _, _, _, _ = _both_fronts(7, False)
    ps_t = convert.planar_setup_from_numpy(ps_j, device="cpu")
    rng = np.random.default_rng(7)
    vals = rng.uniform(0, 1, size=(97, 3, 5)).astype(np.float32)
    tj, aj, pj = jfe.stream_table_planar(
        ps_j, jfe.attribute_plane_cols(ps_j, jfe.attr_corner_cols(
            jnp.asarray(vals))))
    tt, at, pt = tfe.stream_table_planar(
        ps_t, tfe.attribute_plane_cols(ps_t, tfe.attr_corner_cols(
            torch.from_numpy(vals))))
    tj, tt = np.asarray(tj), tt.numpy()
    assert aj == at == 5
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(tj[:, :11], tt[:, :11])
    # Plane bound: 8 ulps of the chain's magnitude, times inv_area.
    coef = np.abs(np.stack([np.asarray(getattr(ps_j, f)) for f in (
        "a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1", "c2")]).reshape(
        3, 3, -1))                                    # [row, corner, T]
    inv = np.asarray(ps_j.inv_area)
    for ch in range(5):
        mag = np.einsum("rct,tc->rt", coef, np.abs(vals[:, :, ch]))
        tol = 8 * 2.0 ** -23 * mag * inv + 1e-30
        got = tt[:, 11 + 3 * ch:14 + 3 * ch].T
        want = tj[:, 11 + 3 * ch:14 + 3 * ch].T
        assert (np.abs(got - want) <= tol).all(), ch
    rj = np.asarray(jfe.pack_records_planar(ps_j, 128))
    rt = tfe.pack_records_planar(ps_t, 128).numpy()
    assert rj.shape == rt.shape == (128, 16)
    np.testing.assert_array_equal(rj, rt)


@pytest.mark.parametrize("cull,n_chan,persp", [
    (False, 5, False), (True, 5, False), (False, 0, False),
    (True, 5, True), (False, 0, True), (False, 8, True)])
def test_planar_front_table_matches_jax(cull, n_chan, persp):
    """planar_front_table on the CPU (no launch) against JAX planar_front
    + stream_table_planar(attribute_plane_cols) (the XLA path, T < 4096),
    with ``persp`` of ``perspective_chan_vals`` (K1's perspective flag):
    the setup within the front-end contraction class, ids, validity and
    poison rows exact, the raster columns the setup's own, the planes
    within the chain's ulps plus the propagated edge-constant difference;
    a NaN attribute of a valid triangle gives NaN planes in both."""
    corners, m, w, h = _random_scene(seed=11)
    rng = np.random.default_rng(11)
    vals = rng.uniform(-1, 1, size=(97, 3, n_chan)).astype(np.float32)
    ps_j = jfe.planar_front(jfe.corner_cols(jnp.asarray(corners)),
                            jnp.asarray(m), w, h, cull_backfaces=cull,
                            pallas=False)
    first_valid = int(np.argmax(np.asarray(ps_j.valid)))
    if n_chan:
        vals[first_valid, 1, n_chan - 1] = np.nan
    chans_j = jfe.attr_corner_cols(jnp.asarray(vals))
    if persp:
        chans_j = jfe.perspective_chan_vals(chans_j, ps_j)
    tj, aj, pj = (np.asarray(x) if i != 1 else x for i, x in enumerate(
        jfe.stream_table_planar(ps_j, jfe.attribute_plane_cols(
            ps_j, chans_j))))
    _cuda.reset_launches()
    ps_t, tt, at, pt = tfe.planar_front_table(
        tfe.corner_cols(torch.from_numpy(corners)), torch.from_numpy(m),
        tfe.attr_corner_cols(torch.from_numpy(vals)), w, h,
        cull_backfaces=cull, perspective=persp)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches
    assert_fe_contraction_class(ps_j, _numpy_fields(ps_t), corners, m,
                                width=w, height=h,
                                context=f"planar_front_table cull={cull}")
    if persp:
        # The values the planes interpolate: each over its corner's w
        # (exact on both sides), then 1/w.
        iw = 1.0 / np.stack([getattr(ps_t, f).numpy() for f in (
            "w1", "w2", "w3")], 1)
        vals = np.concatenate([vals * iw[:, :, None], iw[:, :, None]], -1)
        n_chan += 1
    tt, pt = tt.numpy(), pt.numpy()
    assert aj == at == n_chan and tt.shape == tj.shape == (97, 11 + 3 * n_chan)
    np.testing.assert_array_equal(pt, pj)
    valid = ps_t.valid.numpy()
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(tt[:, 10], tj[:, 10])
    np.testing.assert_array_equal(tt[~valid], tj[~valid])
    np.testing.assert_array_equal(tt[~valid], np.broadcast_to(
        pt, tt[~valid].shape))
    fields = ("a0", "a1", "b0", "b1", "c0", "c1", "abs_d", "zx", "zy", "zc")
    np.testing.assert_array_equal(tt[valid, :10], np.stack(
        [getattr(ps_t, f).numpy()[valid] for f in fields], 1))
    # Planes: 8 ulps of the chain's magnitude (times inv_area), plus the
    # edge constants' difference through the const plane.
    coef = np.abs(np.stack([np.asarray(getattr(ps_j, f)) for f in (
        "a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1", "c2")]).reshape(
        3, 3, -1).astype(np.float64))                 # [row, corner, T]
    dc = np.abs(np.stack([getattr(ps_t, f).numpy() for f in (
        "c0", "c1", "c2")]).astype(np.float64) - coef[2])
    inv = np.asarray(ps_j.inv_area, np.float64)
    for ch in range(n_chan):
        v = np.abs(vals[:, :, ch].astype(np.float64))
        mag = np.einsum("rct,tc->rt", coef, v)
        tol = 8 * 2.0 ** -23 * mag * inv + 1e-30
        tol[2] += np.einsum("ct,tc->t", dc, v) * inv
        got = tt[valid, 11 + 3 * ch:14 + 3 * ch].T
        want = tj[valid, 11 + 3 * ch:14 + 3 * ch].T
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert nan.any() == (ch == n_chan - 1 - persp), ch
        ok = np.abs(got - want) <= tol[:, valid]
        assert (ok | nan).all(), ch


def test_cpu_front_end_runs_plain_without_launches():
    _cuda.reset_launches()
    corners, m, w, h = _random_scene(seed=2)
    cols = torch.from_numpy(corners.transpose(1, 2, 0).reshape(9, -1).copy())
    m16 = torch.from_numpy(m).reshape(16)
    np.testing.assert_array_equal(fe_kernel(cols, m16, w, h).numpy(),
                                  fe_plain(cols, m16, w, h).numpy())
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in neither JAX nor the
    JAX package (the machine with the card has no JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import software_renderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.texture_kernel', 'parallel.batch',"
        " 'parallel.sharding', 'tools.probe_dyngather', 'ops.lines',"
        " 'ops.primitives2d', 'ops.msaa', 'ops.resize', 'utils.config',"
        " 'models.teapot', 'runtime', 'utils.log', 'utils.image_io',"
        " 'utils.checkpoint', 'utils.device', 'utils.timing',"
        " 'utils.profiling', 'utils.present', 'utils.display',"
        " 'parallel.frame_graph', 'tools.sweep_resolve_merge'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'software_renderer_tpu'"
        " or m.startswith('software_renderer_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _premise_corners(rng, w, h):
    """{family: [n, 3, 3] float32 NDC corners (w = 1, z in (0.1, 0.9))}:
    random triangles and adversarial ones for the bbox premise."""
    def tri(xy):
        z = rng.uniform(0.1, 0.9, xy.shape[:2] + (1,))
        return np.concatenate([xy, z], -1).astype(np.float32)

    def ndc(px, py):                 # pixel coordinates -> NDC
        return np.stack([px / w * 2.0 - 1.0, 1.0 - py / h * 2.0], -1)

    n = 160
    p0 = rng.uniform(-1.2, 1.2, (n, 1, 2))
    fams = {"random": tri(p0 + rng.uniform(-0.3, 0.3, (n, 3, 2)))}
    # Slivers: a long edge and a third corner within a pixel or two of it.
    a = rng.uniform(-0.2, 1.2, (n, 2)) * [w, h]
    d = rng.normal(size=(n, 2)) * rng.uniform(5, 3 * w, (n, 1))
    t = rng.uniform(0.0, 1.0, (n, 1))
    perp = np.stack([-d[:, 1], d[:, 0]], -1) / np.linalg.norm(d, axis=1,
                                                             keepdims=True)
    c = a + t * d + perp * rng.uniform(-2.0, 2.0, (n, 1))
    fams["sliver"] = tri(ndc(*np.stack([a, a + d, c], 1).transpose(2, 0, 1)))
    # Corners on half-integer pixel coordinates (round half away).
    hp = rng.integers(-4, [w + 4, h + 4], (n, 3, 2)) + 0.5
    fams["half_integer"] = tri(ndc(hp[..., 0], hp[..., 1]))
    # Near-degenerate: three nearly collinear corners, |2 area| of a few
    # pixels.
    q = rng.integers(0, [w, h], (n, 1, 2)) + rng.integers(
        -40, 40, (n, 1, 2)) * np.array([[[1.0], [2.0], [3.0]]])
    q = q + rng.integers(-1, 2, (n, 3, 2)) * [[[0], [0], [1]]]
    fams["near_degenerate"] = tri(ndc(q[..., 0], q[..., 1]))
    # Larger than the frame, up to far off screen.
    big = rng.uniform(-1.0, 1.0, (n, 3, 2)) * 10.0 ** rng.uniform(
        0.3, 4.0, (n, 1, 1))
    fams["larger_than_frame"] = tri(big)
    return fams


def test_safe_coverage_stays_in_bbox():
    """The premise of the bin walk's cull (csrc/fused.cu): with the plain
    front-end and the plain walk's edge test, no frame pixel outside a
    valid, coverage-safe triangle's (bx0, by0, bx1, by1) passes the edge
    test."""
    w, h = 96, 64
    rng = np.random.default_rng(21)
    xs = torch.arange(w, dtype=torch.float32)[None, None, :] + 0.5
    ys = torch.arange(h, dtype=torch.float32)[None, :, None] + 0.5
    px = torch.arange(w)[None, None, :]
    py = torch.arange(h)[None, :, None]
    for fam, corners in _premise_corners(rng, w, h).items():
        ps = tfe.planar_front(tfe.corner_cols(torch.from_numpy(corners)),
                              torch.eye(4), w, h)
        table, _, _ = tfe.stream_table_planar(ps, [])
        keep = ps.valid & ps.safe
        r = table[keep][:, :, None, None]
        e0 = r[:, 0] * xs + r[:, 2] * ys + r[:, 4]
        e1 = r[:, 1] * xs + r[:, 3] * ys + r[:, 5]
        e2 = r[:, 6] - e0 - e1
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        bb = tfe.bbox_table(ps)[keep][:, :, None, None]
        in_box = ((px >= bb[:, 0]) & (px <= bb[:, 2]) & (py >= bb[:, 1])
                  & (py <= bb[:, 3]))
        assert int(keep.sum()) >= 20, (fam, int(keep.sum()))
        assert bool(inside.any()), fam
        assert not bool((inside & ~in_box).any()), fam
