"""The windowed bilinear sampler: the compacted 1x128 row segments of a
frame sampled through per-segment windows of 8-row texel slabs.

Counterpart of the JAX package's ops/texture_kernel.py. Its TPU kernel
``_sampler_kernel`` (software_renderer_tpu/ops/texture_kernel.py:226)
walks 8-row windows because Mosaic's per-lane gather lowers only at one
[8, 128] vreg. That is the TPU's economics, not the function: since the
window base ``y0`` is 8-aligned, a lane's texel row is ``(y0 + dy) mod
th`` and its +1 row is the next row of the wrap-padded table. So
csrc/sampler.cu (K7) runs one warp per segment, gathers each corner of a
lane in one 16-byte load from the texture's texels (the padded table
interleaved per texel, :func:`windowed_texels`, built once per texture by
``Texture``; 1.1 MB at 256x256, L2-resident) and writes 0 on a lane
outside the segment's windows.

The index prep (:func:`windowed_prep`, :func:`windowed_count`,
:func:`windowed_tables`) is plain torch, as it is XLA in JAX. The
sampler's gradient is :func:`sampler_plain` through autograd: JAX's
backward is XLA (``_windowed_vjp``), not a kernel.

Every frame that takes the windowed sampler adds its segments' window
counts to its device's window counter (:func:`window_counts`) on the
device, with no host sync, so a replayed frame counts too.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..device import resolved

# Window geometry of the TPU kernel: WIN_STRIDE-row windows at 8-aligned
# starts, with WINH wrap-padded rows below the table so that a window's
# +1 row always exists.
WINH = 16
WIN_STRIDE = 8
# Segments per TPU grid step (the card's kernel takes any count).
SEG_PER_STEP = 32
# Lanes of one segment.
LANES = 128


def windowed_supported(th: int, tw: int, c: int, k: int) -> bool:
    """Whether a [th, tw, c] texture and segments of ``k`` lanes take the
    windowed route: JAX's rule (texture_kernel.py:72), kept so that the
    same textures take the same route in both packages. ``th`` must be a
    multiple of WIN_STRIDE (window starts stay 8-aligned across the
    seam); the 128-lane column tiles and the 6 MB term are the TPU's
    lane-gather and VMEM rules, kept for routing parity only."""
    if k != LANES or c < 1 or c > 4:
        return False
    if tw % LANES or tw // LANES > 4:
        return False
    if th < 8 or th % 8 or (th + WINH) * tw * c * 4 > 6 << 20:
        return False
    return True


def _texel_rows(v, th: int, wrap: str):
    """Integer texel row of each lane and its bilinear floor, as
    ops/texture.py's sample_texture_planes computes them."""
    y = v * th - 0.5
    y0f = torch.floor(y)
    if wrap == "repeat":
        ya = torch.remainder(y0f.to(torch.int32), th)
    else:
        ya = torch.clamp(y0f.to(torch.int32), 0, th - 1)
    return y, y0f, ya


def _occupancy(ya, cov, th: int):
    """[cap, th // WIN_STRIDE] bool: which 8-row slabs a segment's
    covered lanes touch."""
    s = th // WIN_STRIDE
    slab = torch.where(cov, ya // WIN_STRIDE, 0).long()
    occ = torch.zeros((ya.shape[0], s), dtype=torch.int32, device=ya.device)
    return occ.scatter_add_(1, slab, cov.to(torch.int32)) > 0


def _window_base(ya, cov, th: int):
    """(base, nwin), [cap] each: the occupied slab from which a segment's
    windows walk circularly over its occupied slabs in the fewest
    windows, and that count (0 for a segment with no covered lane).

    Walking from occupied slab i, the last slab reached is p(i), the
    previous occupied slab strictly before i, circularly, so the walk
    takes 1 + (p(i) - i) mod S windows (S = th / 8): one cummax over the
    doubled slab axis, with no [cap, S, S] span matrix. JAX's prep
    (texture_kernel.py:103) takes the first slab of least span, as
    argmin does here."""
    s = th // WIN_STRIDE
    occ = _occupancy(ya, cov, th)
    sidx = torch.arange(s, dtype=torch.int32, device=ya.device)
    occ2 = torch.cat([occ, occ], dim=1)                        # [cap, 2S]
    j2 = torch.arange(2 * s, dtype=torch.int32, device=ya.device)
    incl = torch.cummax(torch.where(occ2, j2, -1), dim=1).values
    pexcl = torch.nn.functional.pad(incl[:, :-1], (1, 0), value=-1)
    p = torch.remainder(pexcl[:, s:], s)
    span = torch.where(occ, torch.remainder(p - sidx[None, :], s), s + 1)
    base = torch.argmin(span, dim=1)
    minspan = span.gather(1, base[:, None])[:, 0]
    nwin = torch.where(occ.any(dim=1), minspan + 1, 0).to(torch.int32)
    return base, nwin


def windowed_prep(u, v, cov, *, th: int, tw: int, wrap: str):
    """Per-lane and per-segment indices of the windowed sampler.

    u, v: [cap, 128] float32 UV planes; cov: [cap, 128] bool covered mask
    (uncovered lanes are left out of a segment's window base and count;
    their per-lane indices may be anything). The base math is
    sample_texture_planes', expression for expression, so covered texels
    and fractions equal that sampler's.

    The window base is seam-aware, as in JAX (texture_kernel.py:103): the
    windows walk circularly from ``y0``, so the base is the occupied slab
    that minimises the circular span over the segment's occupied slabs
    (a ``repeat`` segment straddling the v seam walks about 2 windows, not
    th/8). Segments with no covered lane get ``nwin = 0``.

    Returns (xa, dy, fx, fy, y0, nwin): xa, dy [cap, 128] int32 (left
    texel column; texel row minus y0, mod th), fx, fy [cap, 128] float32,
    y0, nwin [cap] int32.
    """
    x = u * tw - 0.5
    x0 = torch.floor(x)
    y, y0f, ya = _texel_rows(v, th, wrap)
    fx = x - x0
    fy = y - y0f
    if wrap == "repeat":
        xa = torch.remainder(x0.to(torch.int32), tw)
    else:
        xa = torch.clamp(x0.to(torch.int32), 0, tw - 1)
    base, nwin = _window_base(ya, cov, th)
    y0 = (base * WIN_STRIDE).to(torch.int32)
    dy = torch.remainder(ya - y0[:, None], th).to(torch.int32)
    return xa.to(torch.int32), dy, fx, fy, y0, nwin


def windowed_count(v, cov, *, th: int, wrap: str):
    """Per-segment window count, :func:`windowed_prep`'s ``nwin`` without
    its per-lane indices: the adaptive route's predicate (JAX
    texture_kernel.py:150). Segments with no covered lane return 0.
    [cap] int32."""
    _, _, ya = _texel_rows(v, th, wrap)
    return _window_base(ya, cov, th)[1]


# The window counter of each device: 4 int64 slots, the sums over every
# windowed frame of 1 (frames), its covered segments, its segments with a
# window and its windows (:func:`count_windows`).
_window_counters: dict = {}


def count_windows(cov, nwin) -> None:
    """Add a windowed frame's [cap, 128] covered mask and its [cap]
    window counts (:func:`windowed_prep`'s ``nwin``) to its device's
    window counter, with no host sync, in a few small device operations
    (eight a frame on the card; :func:`window_counts`)."""
    dev = resolved(nwin.device)
    counter = _window_counters.get(dev)
    if counter is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device's first windowed frame makes its "
                               "window counter and must not be captured")
        counter = _window_counters[dev] = torch.zeros(
            4, dtype=torch.int64, device=dev)
    rows = torch.stack((cov.any(dim=1).to(nwin.dtype),
                        torch.clamp(nwin, max=1), nwin))
    counter[1:].add_(rows.sum(1))
    counter[:1].add_(1)


def window_counts(device) -> dict:
    """The window counter of ``device`` since its last reset, read with
    one host sync: ``frames``, the frames that took the windowed sampler
    (routes "1" and "adaptive"; every sampling of a training step too),
    and over them ``covered_segments`` (1 x 128 row segments with a
    covered lane), ``window_segments`` (segments with ``nwin > 0``: the
    same segments, by the window rule) and ``windows`` (the sum of
    ``nwin``). All 0 on a device that sampled no windowed frame."""
    counter = _window_counters.get(resolved(device))
    frames, covered, with_window, windows = (
        [0] * 4 if counter is None else counter.tolist())
    return {"frames": frames, "covered_segments": covered,
            "window_segments": with_window, "windows": windows}


def reset_window_counts(device=None) -> None:
    """Zero the window counter of ``device``, or of every device."""
    for dev, counter in _window_counters.items():
        if device is None or dev == resolved(device):
            counter.zero_()


def windowed_tables(data, wrap: str):
    """[C, th + WINH, tw] float32: the texture's channel planes with WINH
    wrap-padded rows below (``repeat``: the first rows again; ``clamp``:
    the last row), so a window's +1 row never wraps. data: [th, tw, C].
    JAX returns the C planes as a list; here they are one tensor."""
    th = data.shape[0]
    if wrap == "repeat":
        pad = torch.cat([data] * -(-WINH // th), dim=0)[:WINH]
    else:
        pad = data[-1:].expand((WINH,) + tuple(data.shape[1:]))
    full = torch.cat([data, pad], dim=0).to(torch.float32)
    return full.permute(2, 0, 1).contiguous()


def sample_segments_windowed_plain(tables, xa, dy, fx, fy, y0, nwin, *,
                                   th: int, tw: int, wrap: str):
    """Plain version of K7: JAX's ``_xla_equivalent`` corner gathers and
    lerp (texture_kernel.py:319) with the kernel's window mask. A lane
    whose ``dy`` lies in no window [8w, 8w + 8) for w < nwin returns 0.
    ``xa`` is clamped into [0, tw) and rows wrap mod th, so no input
    indexes outside the tables. Differentiable in ``tables``, ``fx`` and
    ``fy``. Returns [C, cap, 128] float32."""
    xa = torch.clamp(xa, 0, tw - 1)
    ya = torch.remainder(y0[:, None] + dy, th)
    if wrap == "repeat":
        xb = torch.where(xa + 1 == tw, 0, xa + 1)
    else:
        xb = torch.clamp(xa + 1, max=tw - 1)
    yb = ya + 1  # row th is the first wrap-padded row
    inside = (dy >= 0) & (dy < WIN_STRIDE * nwin[:, None])
    i00 = (ya * tw + xa).long()
    i01 = (ya * tw + xb).long()
    i10 = (yb * tw + xa).long()
    i11 = (yb * tw + xb).long()
    out = []
    for tab in tables:
        flat = tab.reshape(-1)
        t00, t01, t10, t11 = flat[i00], flat[i01], flat[i10], flat[i11]
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        val = top + (bot - top) * fy
        out.append(torch.where(inside, val, torch.zeros_like(val)))
    return torch.stack(out)


def windowed_texels(data, wrap: str):
    """[th + WINH, tw, 4] float32: :func:`windowed_tables` interleaved per
    texel, the channels padded with zeros to 4, so that K7 reads each
    corner in one 16-byte load. data: [th, tw, C], C <= 4.
    Differentiable in ``data``."""
    tabs = windowed_tables(data, wrap)
    return torch.nn.functional.pad(tabs.permute(1, 2, 0),
                                   (0, 4 - tabs.shape[0])).contiguous()


def sampler_plain(texels, xa, dy, fx, fy, y0, nwin, *, c: int, th: int,
                  tw: int, wrap: str):
    """Plain version of K7 on the texels of :func:`windowed_texels`:
    :func:`sample_segments_windowed_plain` of their first ``c`` channels.
    Returns [c, cap, 128] float32."""
    return sample_segments_windowed_plain(
        texels[..., :c].permute(2, 0, 1), xa, dy, fx, fy, y0, nwin, th=th,
        tw=tw, wrap=wrap)


def sampler_kernel(texels, xa, dy, fx, fy, y0, nwin, *, c: int, th: int,
                   tw: int, wrap: str):
    """Launch K7 (csrc/sampler.cu) on CUDA tensors: the forward of
    :func:`sample_segments_windowed` with no autograd. texels: [th + WINH,
    tw, 4] float32; the rest as :func:`sampler_plain` takes them, every
    array contiguous and 16-byte aligned (the kernel's vector loads).
    Returns [c, cap, 128]."""
    dev = texels.device
    _cuda.require(texels, torch.float32, "texels", shape=(th + WINH, tw, 4),
                  align=16)
    if not 1 <= c <= 4:
        raise ValueError(f"c must be 1 to 4, got {c}")
    if wrap not in ("repeat", "clamp"):
        raise ValueError(f"unknown wrap mode {wrap!r}")
    cap = xa.shape[0]
    for name, t, dtype in (("xa", xa, torch.int32), ("dy", dy, torch.int32),
                           ("fx", fx, torch.float32),
                           ("fy", fy, torch.float32)):
        _cuda.require(t, dtype, name, device=dev, shape=(cap, LANES),
                      align=16)
    _cuda.require(y0, torch.int32, "y0", device=dev, shape=(cap,))
    _cuda.require(nwin, torch.int32, "nwin", device=dev, shape=(cap,))
    out = torch.empty((c, cap, LANES), dtype=torch.float32, device=dev)
    lib = _cuda.lib()
    _cuda.launches["sampler"] += 1
    _cuda.check(lib.sr_sampler(
        texels.data_ptr(), c, th, tw, int(wrap == "repeat"), xa.data_ptr(),
        dy.data_ptr(), fx.data_ptr(), fy.data_ptr(), y0.data_ptr(),
        nwin.data_ptr(), cap, out.data_ptr(), _cuda.stream_of(texels)))
    return out


class _WindowedSampler(torch.autograd.Function):
    """K7 forward; JAX's backward (texture_kernel.py:362-369): autograd
    through the plain version, with respect to the texels and fx/fy.

    A lane outside every window outputs the constant 0, and a lane whose
    cotangent is 0 in every channel adds nothing, so the backward runs
    the plain version on the other lanes only. Uncovered pixels (zero
    cotangent through finish_fused's covered mask) all sample one texel,
    and the index-adds of the gathers' gradients would add their zeros to
    it one at a time.
    """

    @staticmethod
    def forward(ctx, texels, fx, fy, xa, dy, y0, nwin, c, th, tw, wrap):
        ctx.save_for_backward(texels, fx, fy, xa, dy, y0, nwin)
        ctx.geom = dict(c=c, th=th, tw=tw, wrap=wrap)
        return sampler_kernel(texels, xa, dy, fx, fy, y0, nwin, **ctx.geom)

    @staticmethod
    def backward(ctx, grad):
        texels, fx, fy, xa, dy, y0, nwin = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        g_tex = g_fx = g_fy = None
        if any(need):
            seg, lane = torch.nonzero(
                (dy >= 0) & (dy < WIN_STRIDE * nwin[:, None])
                & (grad != 0).any(dim=0), as_tuple=True)
            lanes = lambda t: t[seg, lane][:, None]         # [N, 1]
            tex = texels.detach().requires_grad_(need[0])
            fxs = lanes(fx).requires_grad_(need[1])
            fys = lanes(fy).requires_grad_(need[2])
            wanted = [t for t in (tex, fxs, fys) if t.requires_grad]
            with torch.enable_grad():
                out = sampler_plain(tex, lanes(xa), lanes(dy), fxs, fys,
                                    y0[seg], nwin[seg], **ctx.geom)
                grads = iter(torch.autograd.grad(
                    out, wanted, grad[:, seg, lane][..., None]))

            def full(g):   # [N, 1] lane gradients back to [cap, 128]
                out = torch.zeros_like(fx)
                out[seg, lane] = g[:, 0]
                return out

            g_tex = next(grads) if need[0] else None
            g_fx = full(next(grads)) if need[1] else None
            g_fy = full(next(grads)) if need[2] else None
        return (g_tex, g_fx, g_fy) + (None,) * 8


def sample_segments_windowed(texels, xa, dy, fx, fy, y0, nwin, *, c: int,
                             th: int, tw: int, wrap: str):
    """Bilinear-sample 1x128 segments through their texel windows.

    texels: [th + WINH, tw, 4] float32 (:func:`windowed_texels`, which
    ``Texture`` holds); c: the texture's channel count; xa, dy, fx, fy,
    y0, nwin as :func:`windowed_prep` returns them. Returns [c, cap, 128]
    float32: covered lanes equal sample_texture_planes; lanes outside
    every window are 0. Differentiable in ``texels``, ``fx`` and ``fy``.

    CPU tensors run :func:`sampler_plain`; CUDA tensors launch K7 through
    an autograd Function whose backward is the plain version's.
    """
    if texels.device.type == "cpu":
        return sampler_plain(texels, xa, dy, fx, fy, y0, nwin, c=c, th=th,
                             tw=tw, wrap=wrap)
    return _WindowedSampler.apply(texels, fx, fy, xa, dy, y0, nwin, c, th,
                                  tw, wrap)
