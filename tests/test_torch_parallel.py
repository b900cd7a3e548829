"""PyTorch port, parallel/: the chunked batch, the (frames, rows) mesh
and ``render_sharded`` with and without the split front-end, the
training step over a mesh, and array-like transforms, on the CPU.

Tolerances: the chunked batch equals ``render_batch`` bit for bit (the
same frames, rendered one after another), and the meshless training
step equals the 2 x 1 mesh's bit for bit (its bands are whole frames,
summed in the same order). ``render_sharded`` against JAX's
``render_sharded`` (``backend="reference"``, 64x64, 4 frames):
alpha exact, color and depth in the JAX package's depth-tie class
(``assert_tie_class_equal`` at its default 1e-3, the tolerance of JAX's
own sharded test). The gathered front-end and stream table equal the
unsplit ones bit for bit (K1 is per-triangle). The training step on a
2 x 2 mesh against JAX's on a 2 x 2 virtual-CPU mesh: loss rtol 1e-5,
texels within 1e-6 on reference and 1e-5 on auto.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops import texture as jtex
from software_renderer_tpu.ops import transforms as jtf
from software_renderer_tpu.parallel import sharding as jsharding
from software_renderer_tpu.testing.compare import assert_tie_class_equal
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.parallel.batch import (
    render_batch, render_batch_chunked)
from software_renderer_tpu_torch.parallel.sharding import (
    make_mesh, render_sharded, sharded_front, texture_train_step)
from software_renderer_tpu_torch.render import (
    planar_front_table_of, render, render_rows)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_sphere():
    """The 9-segment sphere of the JAX package's tests/test_parallel.py
    (built once: JAX's eager shape builder costs seconds op by op)."""
    mesh = sr.shapes.uv_sphere(radius=0.2, segments=9, inward_normals=True)
    return sr.RenderPass(mesh=mesh, transform=jnp.eye(4), width=64,
                         height=64, shading="vertex")


def _port_of(rp):
    return convert.render_pass_from_numpy(
        convert.arrays_of(rp), device="cpu", **convert.static_fields_of(rp))


def _jax_pass(rp):
    """The JAX RenderPass of a port RenderPass on the CPU (JAX's eager
    scene builders cost seconds op by op); the texture is handed the
    port's table, which equals JAX's."""
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    m = rp.mesh
    mesh = sr.Mesh(**{f: j(getattr(m, f)) for f in (
        "positions", "indices", "colors", "normals", "uvs")})
    light = None if rp.light is None else jsh.Light(
        *(j(getattr(rp.light, f.name)) for f in dataclasses.fields(
            rp.light)))
    tex = jtex.Texture(data=j(rp.texture.data), filter=rp.texture.filter,
                       wrap=rp.texture.wrap, table=j(rp.texture.table),
                       table_pack=1)
    return sr.RenderPass(
        mesh=mesh, transform=j(rp.transform), light=light, texture=tex,
        flat_color=j(rp.flat_color), model=j(rp.model),
        **{f: getattr(rp, f) for f in convert.STATIC_FIELDS})


@functools.lru_cache(maxsize=None)
def _demo_transforms():
    return np.array(jax.vmap(jtf.reference_demo_transform)(
        jnp.linspace(0.0, 1.0, 4)))


def _transforms(n):
    """The first n of 4 transforms of the reference demo over [0, 1] s
    (one JAX trace for every test)."""
    return _demo_transforms()[:n].copy()


@pytest.fixture(scope="module")
def sharded_jax():
    """JAX's render_sharded on a 2 x 2 mesh of virtual CPU devices."""
    mesh = jsharding.make_mesh(2, 2, jax.devices()[:4])
    fb = jsharding.render_sharded(_jax_sphere(), _transforms(4), mesh,
                                  backend="reference")
    return np.asarray(fb.color), np.asarray(fb.depth)


@pytest.mark.parametrize("shard_frontend", [True, False])
def test_render_sharded_matches_jax(sharded_jax, shard_frontend):
    cj, dj = sharded_jax
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    assert mesh.shape == {"frames": 2, "rows": 2}
    _cuda.reset_launches()
    fb = render_sharded(_port_of(_jax_sphere()), _transforms(4), mesh,
                        backend="reference", shard_frontend=shard_frontend)
    assert all(v == 0 for v in _cuda.launches.values())
    ct, dt = fb.color.numpy(), fb.depth.numpy()
    assert ct.shape == (4, 64, 64, 4) and dt.shape == (4, 64, 64)
    assert ct[..., 3].any(), "nothing covered: vacuous"
    np.testing.assert_array_equal(ct[..., 3], cj[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt,
                           context=f"render_sharded {shard_frontend}")


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_render_sharded_equals_render_batch(backend):
    """Bands stitch to the whole frame; on the CPU bit for bit."""
    rp = _port_of(_jax_sphere())
    ts = _transforms(4)
    ref = render_batch(rp, ts, backend=backend)
    for mesh in (make_mesh(2, 2, ["cpu"] * 4), make_mesh(1, 1, ["cpu"])):
        fb = render_sharded(rp, ts, mesh, backend=backend)
        assert torch.equal(fb.color, ref.color)
        assert torch.equal(fb.depth, ref.depth)


def test_sharded_front_gathers_the_unsplit_front():
    """Row shards over config 4's triangles (padded to a multiple of the
    shard count): the gathered columns and stream table (global ids,
    the textured pass's channels) equal the unsplit front-end's bit for
    bit, the padding is invalid (poison rows), and bands given the
    gathered front and table stitch to the main path's frame."""
    rp = tscenes.config4_many_objects(0.0, width=96, height=64,
                                      triangles=3000, device="cpu")
    t = rp.mesh.indices.numel() // 3
    ref, (ref_table, ref_chans, _) = planar_front_table_of(rp)
    assert ref_chans > 0 and ref_table.shape[0] == t
    assert torch.equal(ref_table[:, 10][ref.valid],
                       torch.nonzero(ref.valid)[:, 0].float())
    for n in (3, 7):
        devs = [torch.device("cpu")] * n
        front = sharded_front(rp.to, rp.transform, devs)
        assert list(front) == [torch.device("cpu")]
        ps, (table, n_chans, poison) = front[torch.device("cpu")]
        assert ps.num_triangles == table.shape[0] == -(-t // n) * n >= t
        assert n_chans == ref_chans
        for f in dataclasses.fields(tfe.PlanarSetup):
            got = getattr(ps, f.name)
            assert torch.equal(got[:t], getattr(ref, f.name)), f.name
        assert torch.equal(table[:t], ref_table)
        assert not bool(ps.valid[t:].any())
        assert torch.equal(table[t:], poison.expand(table.shape[0] - t, -1))
    full = render(rp)
    for y0, rows in ((0, 24), (24, 40)):
        band = render_rows(rp, y0, rows, front=ps, table=(table, n_chans,
                                                          poison))
        assert torch.equal(band.color, full.color[y0:y0 + rows])
        assert torch.equal(band.depth, full.depth[y0:y0 + rows])


@pytest.mark.parametrize("chunk", [1, 2])
def test_render_batch_chunked_equals_render_batch(chunk):
    rp = _port_of(_jax_sphere())
    ts = torch.from_numpy(_transforms(4))
    ref = render_batch(rp, ts, backend="binned")
    fb = render_batch_chunked(rp, ts, backend="binned", vmap_chunk=chunk)
    assert torch.equal(fb.color, ref.color)
    assert torch.equal(fb.depth, ref.depth)
    with pytest.raises(AssertionError):
        render_batch_chunked(rp, ts[:3], vmap_chunk=2)


def test_render_batch_takes_a_numpy_stack():
    """JAX's render_batch takes any array-like (jnp.asarray); so does the
    port's, a numpy stack and a nested list among them."""
    rp = _port_of(_jax_sphere())
    ts = _transforms(2)
    ref = render_batch(rp, torch.from_numpy(ts))
    for arg in (ts, ts.tolist()):
        fb = render_batch(rp, arg)
        assert torch.equal(fb.color, ref.color)
    assert ref.color[..., 3].any()


def test_frame_graph_key_and_cpu_route(monkeypatch):
    """The compiled frame's bookkeeping on the CPU: render_batch renders
    CPU frames eagerly and counts them; the capture key ignores the
    transform and changes with what a capture bakes in (the mesh's
    memory, the options, the sampler route, the backend)."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    rp = _port_of(_jax_sphere())
    ts = torch.from_numpy(_transforms(3))
    fg.reset_routes()
    render_batch(rp, ts)
    assert fg.routes == {"capture": 0, "replay": 0, "eager": 3}
    assert not fg.capturable(rp, "auto")
    key = fg._key(rp, "auto")
    assert fg._key(dataclasses.replace(rp, transform=ts[1]), "auto") == key
    other_mesh = dataclasses.replace(rp.mesh, positions=rp.mesh.positions
                                     .clone())
    for changed in (dataclasses.replace(rp, mesh=other_mesh),
                    dataclasses.replace(rp, width=rp.width + 8),
                    dataclasses.replace(rp, cull_backfaces=True),
                    dataclasses.replace(rp, flat_color=torch.zeros(3))):
        assert fg._key(changed, "auto") != key
    assert fg._key(rp, "binned") != key
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "1")
    assert fg._key(rp, "auto") != key


def _stub_capture(monkeypatch, capturable=lambda rp, backend: True):
    """The card's capture and replay stubbed on the CPU: a frame is its
    transform's entries (0, 3) in colour and (1, 3) in depth, and a
    replay writes the frame of the graph's static transform into its
    outputs. Returns the stub's frame function and a 3-triangle mesh."""
    import types
    from software_renderer_tpu_torch.framebuffer import Framebuffer
    from software_renderer_tpu_torch.models.mesh import mesh_from_numpy
    from software_renderer_tpu_torch.parallel import frame_graph as fg

    def frame(t):
        return Framebuffer(color=t[0, 3].expand(2, 3, 4).clone(),
                           depth=t[1, 3].expand(2, 3).clone())

    def capture(self, rp, backend):
        static_t = rp.transform.clone()
        out = frame(static_t)

        def replay():
            out.color.copy_(frame(static_t).color)
            out.depth.copy_(frame(static_t).depth)
        return fg._Capture(types.SimpleNamespace(replay=replay), static_t,
                           out, {}, rp, (), "sr.frame_graph.replay")

    monkeypatch.setattr(fg, "capturable", capturable)
    monkeypatch.setattr(fg, "render", lambda rp, backend: frame(rp.transform))
    monkeypatch.setattr(fg.FrameGraph, "_capture", capture)
    return frame, mesh_from_numpy(np.eye(3), [0, 1, 2], device="cpu")


def test_render_batch_keeps_its_captures_across_calls(monkeypatch):
    """render_batch's one FrameGraph for the process, with the card's
    capture and replay stubbed (a replay writes the frame's transform
    into the graph's outputs): a second call with the same pass replays
    every frame; a pass with other data pointers gets its own capture;
    the cache holds at most MAX_CAPTURES and drops the least recently
    used first, each drop counted in ``evictions``."""
    from software_renderer_tpu_torch.parallel import batch
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    from software_renderer_tpu_torch.render import RenderPass

    _, mesh = _stub_capture(monkeypatch)
    monkeypatch.setattr(batch, "_graph", fg.FrameGraph())
    passes = [RenderPass(mesh=dataclasses.replace(
        mesh, positions=mesh.positions.clone()), transform=torch.eye(4),
        width=3, height=2) for _ in range(fg.MAX_CAPTURES + 2)]
    ts = torch.eye(4).repeat(3, 1, 1)
    ts[:, 0, 3] = torch.tensor([1.0, 2.0, 3.0])
    ts[:, 1, 3] = torch.tensor([-1.0, -2.0, -3.0])

    def run(i, captures):
        fg.reset_routes()
        fb = render_batch(passes[i], ts)
        assert fg.routes == {"capture": captures, "replay": 3 - captures,
                             "eager": 0}, (i, fg.routes)
        assert torch.equal(fb.color[:, 0, 0, 0], ts[:, 0, 3])
        assert torch.equal(fb.depth[:, 1, 2], ts[:, 1, 3])

    evicted = fg.evictions
    run(0, 1)
    run(0, 0)
    for i in range(1, fg.MAX_CAPTURES):
        run(i, 1)
    assert len(batch._graph._captures) == fg.MAX_CAPTURES
    assert fg.evictions == evicted
    run(0, 0)                   # pass 0 is now the most recently used
    run(fg.MAX_CAPTURES, 1)     # drops pass 1
    assert len(batch._graph._captures) == fg.MAX_CAPTURES
    assert fg.evictions == evicted + 1
    run(0, 0)
    run(1, 1)                   # captured again; drops pass 2
    run(fg.MAX_CAPTURES + 1, 1)  # drops pass 3
    assert fg.evictions == evicted + 3
    kept = [c.rp.mesh for c in batch._graph._captures.values()]
    want = [*range(4, fg.MAX_CAPTURES + 1), 0, 1, fg.MAX_CAPTURES + 1]
    assert all(m is passes[i].mesh for m, i in zip(kept, want, strict=True))


def test_frame_graph_repeats_a_pass_given_its_transform_apart(monkeypatch):
    """A FrameGraph called with the same pass object and its transform
    apart, as FrameLoop calls it, builds the capture's key once and then
    replays the last call's capture under each call's transform; a new
    sampler route, a pass tensor that comes to require grad, another
    pass object, backend or transform dtype, and a call without a
    transform apart each make the next call build the key again (the
    card's capture and replay stubbed)."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    from software_renderer_tpu_torch.render import RenderPass

    _, mesh = _stub_capture(monkeypatch, lambda rp, backend: not any(
        t.requires_grad for t in fg._tensors(rp)))
    keys, key = [], fg._key
    monkeypatch.setattr(fg, "_key", lambda rp, b: keys.append(b) or key(rp, b))
    graph = fg.FrameGraph()
    rp = RenderPass(mesh=mesh, transform=torch.eye(4), width=3, height=2)
    ts = torch.eye(4).repeat(4, 1, 1)
    ts[:, 0, 3] = torch.tensor([1.0, 2.0, 3.0, 4.0])

    def frames(p, want_keys, backend="auto", dtype=torch.float32):
        keys.clear()
        for t in ts:
            fb = graph(p, backend, transform=t.to(dtype))
            assert float(fb.color[0, 0, 0]) == float(t[0, 3])
        assert len(keys) == want_keys, keys

    fg.reset_routes()
    frames(rp, 1)
    assert fg.routes == {"capture": 1, "replay": 3, "eager": 0}
    frames(rp, 0)
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "1")
    frames(rp, 1)                      # a new key: captured again
    mesh.positions.requires_grad_(True)
    fg.reset_routes()
    frames(rp, 0)                      # no graph holds it
    assert fg.routes == {"capture": 0, "replay": 0, "eager": 4}
    mesh.positions.requires_grad_(False)
    frames(rp, 1)
    frames(dataclasses.replace(rp), 1)
    frames(rp, 1, backend="binned")
    frames(rp, 1, dtype=torch.float64)
    graph(rp)
    frames(rp, 1)
    assert fg.routes["eager"] == 4


def test_texture_train_step_over_a_mesh_equals_meshless():
    """JAX's argument order (tex, rp, transforms, targets, mesh, lr=...):
    a 2 x 1 mesh of CPU devices gives the meshless step bit for bit, and
    a 1 x 2 mesh (two bands, the split front-end) within 1e-6."""
    rp = tscenes.config2_textured_cube(0.7, width=48, height=32,
                                       device="cpu")
    ts = torch.stack([rp.transform, rp.transform @ torch.tensor(
        [[1.0, 0, 0, 0.05], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])])
    targets = render_batch(rp, ts).color
    tex0 = torch.full_like(rp.texture.data, 0.5)
    new, loss = texture_train_step(tex0, rp, ts, targets, lr=5000.0)
    assert float(loss) > 0 and not torch.equal(new, tex0)
    new_m, loss_m = texture_train_step(
        tex0, rp, ts, targets, make_mesh(2, 1, ["cpu"] * 2), lr=5000.0)
    assert torch.equal(new_m, new) and torch.equal(loss_m, loss)
    new_r, loss_r = texture_train_step(
        tex0, rp, ts, targets, make_mesh(1, 2, ["cpu"] * 2), lr=5000.0)
    assert abs(float(loss_r) - float(loss)) <= 1e-6 * float(loss)
    assert float((new_r - new).abs().max()) <= 1e-6


@pytest.mark.parametrize("backend,mode", [("reference", "0"), ("auto", "1")])
def test_texture_train_step_over_a_mesh_matches_jax(monkeypatch, backend,
                                                    mode):
    """JAX's texture_train_step on a 2 x 2 mesh of virtual CPU devices
    (its split front-end and psum) against the port's on make_mesh(2, 2)
    of the CPU: config 2 at 128x128, the two frames of
    tests/test_torch_texture.py's meshless comparison (their triangle
    ids agree between the packages), one step at lr 5000 from a flat 0.5
    texture (the scenes built by the port and handed to JAX). Its
    tolerances: loss rtol 1e-5, texels within 1e-6 on reference and 1e-5
    on auto."""
    rps = [tscenes.config2_textured_cube(t, width=128, height=128,
                                         device="cpu") for t in (0.1, 1.1)]
    rp, rp_j = rps[0], _jax_pass(rps[0])
    ts_j = jnp.stack([jnp.asarray(r.transform.numpy()) for r in rps])
    targets_j = jnp.stack([sr.render(dataclasses.replace(
        rp_j, transform=t), backend="reference").color for t in ts_j])
    tex0 = np.full(rp_j.texture.data.shape, 0.5, np.float32)
    lr = 5000.0
    jnew, jloss = jsharding.texture_train_step(
        jnp.asarray(tex0), rp_j, ts_j, targets_j,
        jsharding.make_mesh(2, 2, jax.devices()[:4]), lr=lr,
        backend="reference")
    jnew = np.asarray(jnew)
    assert np.abs(jnew - tex0).max() > 1e-2
    monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
    new, loss = texture_train_step(
        torch.from_numpy(tex0), rp, np.array(ts_j),
        torch.from_numpy(np.array(targets_j)),
        make_mesh(2, 2, ["cpu"] * 4), lr=lr, backend=backend)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(
        new.numpy(), jnew, rtol=0,
        atol=1e-6 if backend == "reference" else 1e-5)
