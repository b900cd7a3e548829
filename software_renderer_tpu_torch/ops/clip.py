"""Near-plane handling: the cull threshold and the exact clip.

Counterpart of the JAX package's ops/clip.py. By default a triangle with
any corner at clip-space w <= CLIP_EPS is culled (ops/frontend.py).
``RenderPass(clip_near=True)`` instead clips each triangle against the
plane w = CLIP_EPS in clip space (Sutherland-Hodgman over a fixed table):
one triangle becomes at most two, so the output is a static [2T] array,
slot t the (possibly clipped) triangle and slot T + t the second half of
a clipped quad. Each new corner carries its barycentric weights over the
source triangle's corners, so attributes interpolate through the cut.

The numpy oracle (the JAX package's testing/oracle.py
``oracle_clip_near``) walks the same polygon, so clipped coverage can be
compared exactly.

:func:`clip_front` is the clip front-end in torch operations (the
``reference`` and ``pallas`` backends take its TriangleSetup). The main
path takes :func:`clip_front_table`: on the card one launch of the clip
front-end kernel (csrc/clip_front.cu) gathers the corners and attribute
values, clips, sets up both slots and writes their stream table;
:func:`clip_front_table_plain`, its plain version, is the same chain in
torch operations and runs for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _cuda
from ..device import constant
from .setup import triangle_setup_from_corners
from .vertex import clip_coords, ndc_to_screen

# Corners at clip-space w <= CLIP_EPS cull their triangle. The value is
# the float32 rounding of 1e-6, the same constant the JAX package uses.
CLIP_EPS = float(np.float32(1e-6))

# Output quad per behind-mask case (b0 + 2 b1 + 4 b2). Candidate corners:
# 0-2 the source corners, 3 the cut of edge (0, 1), 4 of edge (1, 2), 5
# of edge (2, 0). A three-corner output repeats its last corner, which
# makes its second triangle degenerate.
_QUAD_LUT = [
    [0, 1, 2, 2],  # 0: none behind   -> the source triangle
    [5, 3, 1, 2],  # 1: v0 behind     -> quad
    [0, 3, 4, 2],  # 2: v1 behind     -> quad
    [5, 4, 2, 2],  # 3: v0, v1 behind -> one triangle
    [5, 0, 1, 4],  # 4: v2 behind     -> quad
    [3, 1, 4, 4],  # 5: v0, v2 behind -> one triangle
    [5, 0, 3, 3],  # 6: v1, v2 behind -> one triangle
    [0, 0, 0, 0],  # 7: all behind    -> culled
]
_TRI2_VALID = [False, True, True, False, True, False, False, False]


def transform_corners_clip(corners, transform) -> torch.Tensor:
    """[T, 3, 3] model-space corners -> [T, 3, 4] clip space, with the
    planar front-end's multiply-add chains, so that a triangle wholly in
    front (case 0) gives the unclipped path's values bit for bit."""
    return clip_coords(corners, transform)


def cull_behind_mask(clip, eps: float = CLIP_EPS) -> torch.Tensor:
    """[T] bool: every corner's w > eps (the default near-plane guard)."""
    return (clip[:, :, 3] > eps).all(dim=1)


def clip_near(clip, eps: float = CLIP_EPS):
    """Clip [T, 3, 4] clip-space triangles against w = eps.

    Returns (out_clip [2T, 3, 4] corners, bary [2T, 3, 3] weights of each
    output corner over its source triangle's corners, valid [2T] bool).
    """
    t = clip.shape[0]
    dev = clip.device
    w = clip[:, :, 3]
    behind = (w < eps).to(torch.int64)
    case = behind[:, 0] + 2 * behind[:, 1] + 4 * behind[:, 2]

    def intersect(a, b):
        # s on edge (a, b): s = (eps - w_a) / (w_b - w_a);
        # P = P_a + s (P_b - P_a). Computed for every triangle; the table
        # selects the cuts a case uses.
        den = w[:, b] - w[:, a]
        s = (eps - w[:, a]) / torch.where(torch.abs(den) > 0.0, den, 1.0)
        p = clip[:, a] + s[:, None] * (clip[:, b] - clip[:, a])
        e = torch.zeros((t, 3), dtype=torch.float32, device=dev)
        e[:, a] = 1.0 - s
        e[:, b] = s
        return p, e

    cuts = [intersect(0, 1), intersect(1, 2), intersect(2, 0)]
    cand_p = torch.stack([clip[:, 0], clip[:, 1], clip[:, 2]]
                         + [p for p, _ in cuts], dim=1)        # [T, 6, 4]
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(t, 3, 3)
    cand_b = torch.cat([eye, torch.stack([e for _, e in cuts], dim=1)],
                       dim=1)                                  # [T, 6, 3]
    sel = constant(_QUAD_LUT, dev, torch.int64)[case]         # [T, 4]
    quad_p = torch.gather(cand_p, 1, sel[:, :, None].expand(-1, -1, 4))
    quad_b = torch.gather(cand_b, 1, sel[:, :, None].expand(-1, -1, 3))
    # The two triangles of the quad: corners (0, 1, 2) and (0, 2, 3).
    second = constant((0, 2, 3), dev, torch.int64)
    out_clip = torch.cat([quad_p[:, :3], quad_p[:, second]])
    bary = torch.cat([quad_b[:, :3], quad_b[:, second]])
    valid = torch.cat([case != 7,
                       constant(_TRI2_VALID, dev, torch.bool)[case]])
    return out_clip, bary, valid


def compose_attrs(bary, attrs) -> torch.Tensor:
    """Per-corner attributes through the clip: bary [2T, 3, 3] from
    :func:`clip_near`, attrs [T, 3, A] at the source corners -> [2T, 3, A],
    ``out[t, i] = sum_j bary[t, i, j] * attrs[t mod T, j]``."""
    a2 = torch.cat([attrs, attrs])
    return (bary[:, :, 0:1] * a2[:, None, 0] + bary[:, :, 1:2] * a2[:, None, 1]
            + bary[:, :, 2:3] * a2[:, None, 2])


def clip_front(corners, transform, width: int, height: int, *,
               cull_backfaces: bool = False):
    """The near-plane clip front-end: [T, 3, 3] model-space corners ->
    (TriangleSetup of the [2T] clipped triangles, bary [2T, 3, 3] of
    their corners over the source corners, w [2T, 3] clip-space w).

    A triangle wholly in front (case 0) keeps its corners and gets the
    planar front-end's setup bit for bit: the same multiply-add chains,
    divide and rounding, and the same setup math (ops/setup.py
    ``setup_columns``)."""
    clip, bary, cvalid = clip_near(transform_corners_clip(corners, transform))
    w = clip[:, :, 3]
    ndc = clip[:, :, :3] / torch.where(w == 0.0, 1.0, w)[:, :, None]
    t2 = ndc.shape[0]
    screen = ndc_to_screen(ndc.reshape(t2 * 3, 3), width, height).reshape(
        t2, 3, 3)
    setup = triangle_setup_from_corners(
        screen, width, height, cull_backfaces=cull_backfaces,
        extra_valid=cvalid)
    return setup, bary, w


def clipped_channels(corners, transform, vals, width: int, height: int, *,
                     cull_backfaces: bool, perspective: bool):
    """:func:`clip_front` and the channel values of its triangles: (setup,
    [2T, 3, A] values through the clip, each over its corner's w and a
    last 1/w channel with ``perspective``; None where ``vals``, the
    [T, 3, A] source values, is None)."""
    from .shading import perspective_vertex_attrs
    setup, bary, w_c = clip_front(corners, transform, width, height,
                                  cull_backfaces=cull_backfaces)
    if vals is None:
        return setup, None
    vals = compose_attrs(bary, vals)
    if perspective:
        vals = perspective_vertex_attrs(vals, w_c)
    return setup, vals


# Channels of the stream table the clip front-end kernel writes, as the
# planar front-end kernel's (ops/frontend_kernel.py MAX_CHANNELS), over at
# most MAX_SOURCES vertex arrays.
MAX_CHANNELS = 9
MAX_SOURCES = 3
# The float32 rows the kernel writes, in order (PlanarSetup's names; w1-w3
# are NaN, as ops/frontend.py ``from_setup`` leaves them: a clipped slot
# keeps no clip-space w); then the int32 bbox rows and the bool valid and
# safe rows.
CLIP_ROWS = ("a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1", "c2",
             "zx", "zy", "zc", "abs_d", "inv_area", "area2", "w1", "w2", "w3")
_BBOX_ROWS = ("bx0", "by0", "bx1", "by1")
_FLAG_ROWS = ("valid", "safe")


def clip_front_table_plain(positions, indices, sources, normal_matrix,
                           transform, width: int, height: int, *,
                           cull_backfaces: bool = False,
                           perspective: bool = False):
    """Plain version of :func:`clip_front_table`, in torch operations:
    the corner and attribute gathers (the normals rotated by
    ``normal_matrix`` with the multiply-add chain of render.py
    ``shading_inputs``), :func:`clipped_channels`, ``frontend.as_planar``
    and ``binning.stream_table_of``."""
    from .binning import stream_table_of
    from .frontend import as_planar
    tris = indices.reshape(-1, 3).long()
    vals = None
    if sources:
        parts = []
        for values, rotate in sources:
            g = values[tris]
            if rotate and normal_matrix is not None:
                nm = normal_matrix
                g = torch.stack([nm[i, 0] * g[..., 0] + nm[i, 1] * g[..., 1]
                                 + nm[i, 2] * g[..., 2] for i in range(3)],
                                dim=-1)
            parts.append(g)
        vals = torch.cat(parts, dim=-1)
    setup, vals = clipped_channels(
        positions[tris], transform, vals, width, height,
        cull_backfaces=cull_backfaces, perspective=perspective)
    ps = as_planar(setup)
    return ps, stream_table_of(ps, vals)


def clip_front_table(positions, indices, sources, normal_matrix, transform,
                     width: int, height: int, *, cull_backfaces: bool = False,
                     perspective: bool = False):
    """The clip front-end of the main path: (PlanarSetup of the [2T]
    slots, (table [2T, 11 + 3 (A + perspective)], n_channels, poison)).

    positions: [N, 3] float32 vertices; indices: [3T] (or [T, 3]) vertex
    indices; sources: (values [N, k] float32, rotate) per attribute array
    in channel order (A channels in all, at most MAX_SOURCES arrays),
    ``rotate`` marking the normals ([N, 3]), which ``normal_matrix``
    ([3, 3], or None) rotates; transform: [4, 4]. ``perspective``: the
    channels over each corner's clip w, then 1/w (needs a channel).

    Slot t is source triangle t, clipped; slot T + t the second triangle
    of its quad (ops/clip.py :func:`clip_near`). CPU tensors run
    :func:`clip_front_table_plain`; CUDA tensors launch the clip
    front-end kernel once, and its outputs equal the plain version's bit
    for bit on the same card (the library's ``--fmad=false`` and IEEE
    division; the kernel repeats the chain's operations in its order).
    On the card an index outside the vertex arrays gives NaN corners, an
    invalid triangle, where the plain version raises.
    """
    a = sum(values.shape[1] for values, _ in sources)
    if perspective and not a:
        raise ValueError("the perspective channels need an attribute")
    if len(sources) > MAX_SOURCES or a + perspective > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_SOURCES} arrays and {MAX_CHANNELS} "
                         f"channels with 1/w, got {len(sources)} and "
                         f"{a + perspective}")
    if positions.device.type == "cpu":
        return clip_front_table_plain(
            positions, indices, sources, normal_matrix, transform, width,
            height, cull_backfaces=cull_backfaces, perspective=perspective)
    return _card_clip_front(positions, indices, sources, normal_matrix,
                            transform, width, height, cull_backfaces,
                            perspective, a)


def _card_clip_front(positions, indices, sources, normal_matrix, transform,
                     width, height, cull_backfaces, perspective, a):
    """Check the CUDA inputs and launch the clip front-end kernel."""
    from .frontend import PlanarSetup, _stream_poison
    dev = positions.device
    _cuda.require(positions, torch.float32, "positions", ndim=2)
    n_vert = positions.shape[0]
    if positions.shape[1] != 3:
        raise ValueError(f"positions must be [N, 3], got "
                         f"{tuple(positions.shape)}")
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int32)
    indices = indices.reshape(-1)
    _cuda.require(indices, torch.int32, "indices", device=dev)
    if indices.numel() % 3:
        raise ValueError("triangle index count must be a multiple of 3")
    t = indices.numel() // 3
    if 2 * t >= 2 ** 24:
        raise ValueError(f"{t} triangles: the table's slot ids (float32) "
                         "are exact below 2^23 triangles")
    ptrs, ks, rot = [None] * MAX_SOURCES, [0] * MAX_SOURCES, -1
    for s, (values, rotate) in enumerate(sources):
        _cuda.require(values, torch.float32, f"sources[{s}]", device=dev,
                      ndim=2)
        if values.shape[0] != n_vert:
            raise ValueError(f"sources[{s}] has {values.shape[0]} rows, "
                             f"the mesh {n_vert} vertices")
        ptrs[s], ks[s] = values.data_ptr(), values.shape[1]
        if rotate and normal_matrix is not None:
            if values.shape[1] != 3 or rot >= 0:
                raise ValueError("one [N, 3] array of normals is rotated")
            rot = s
    nm = None
    if rot >= 0:
        nm = normal_matrix.to(torch.float32).reshape(9).contiguous()
        _cuda.require(nm, torch.float32, "normal_matrix", device=dev)
    m = transform.to(dtype=torch.float32, device=dev).reshape(16)
    m = m.contiguous()
    t2 = 2 * t
    rows = torch.empty((len(CLIP_ROWS), t2), dtype=torch.float32, device=dev)
    bbox = torch.empty((4, t2), dtype=torch.int32, device=dev)
    flags = torch.empty((2, t2), dtype=torch.bool, device=dev)
    n_cols = 11 + 3 * (a + perspective)
    table = torch.empty((t2, n_cols), dtype=torch.float32, device=dev)
    if t:
        _cuda.launches["clip_front"] += 1
        _cuda.check(_cuda.lib().sr_clip_front(
            indices.data_ptr(), t, positions.data_ptr(), n_vert,
            ptrs[0], ks[0], ptrs[1], ks[1], ptrs[2], ks[2], rot,
            None if nm is None else nm.data_ptr(), int(perspective),
            m.data_ptr(), width, height, int(cull_backfaces), CLIP_EPS,
            rows.data_ptr(), bbox.data_ptr(), flags.data_ptr(),
            table.data_ptr(), _cuda.stream_of(positions)))
    ps = PlanarSetup(**dict(zip(CLIP_ROWS, rows.unbind(0))),
                     **dict(zip(_BBOX_ROWS, bbox.unbind(0))),
                     **dict(zip(_FLAG_ROWS, flags.unbind(0))))
    return ps, (table, a + perspective, _stream_poison(n_cols, dev))
