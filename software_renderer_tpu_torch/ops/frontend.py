"""Planar (structure-of-arrays) geometry front-end.

Every per-triangle quantity is a separate [T] column: the vertex
transform (4x4 as scalar multiply-add chains), perspective divide,
NDC -> pixel with round-half-away, sign-folded exact edge functions, the
depth plane, the clamped bbox and the valid/safe flags. The semantics are
those of the JAX package's ops/frontend.py; :func:`_front_math` is the
plain version of the CUDA front-end kernel (ops/frontend_kernel.py),
which evaluates the same operations in the same order, one thread per
triangle, without contracting multiply-adds.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import constant
from .clip import CLIP_EPS
from .rasterize_kernel import pack_records
from .setup import TriangleSetup, setup_columns
from .vertex import round_half_away


@dataclasses.dataclass
class PlanarSetup:
    """Per-triangle rasterization data as separate [T] columns.

    Edge functions ``e_j = a_j * x + b_j * y + c_j``; a pixel is inside
    when all ``e_j >= 0`` (sign-folded, exact in float32).
    """

    a0: torch.Tensor; a1: torch.Tensor; a2: torch.Tensor  # noqa: E702
    b0: torch.Tensor; b1: torch.Tensor; b2: torch.Tensor  # noqa: E702
    c0: torch.Tensor; c1: torch.Tensor; c2: torch.Tensor  # noqa: E702
    zx: torch.Tensor; zy: torch.Tensor; zc: torch.Tensor  # noqa: E702
    abs_d: torch.Tensor      # |D|, 0 where invalid
    inv_area: torch.Tensor   # 1/|D|, 0 where invalid
    area2: torch.Tensor      # signed 2*area D
    bx0: torch.Tensor; by0: torch.Tensor  # noqa: E702
    bx1: torch.Tensor; by1: torch.Tensor  # int32 bbox, clamped  # noqa: E702
    valid: torch.Tensor      # bool
    w1: torch.Tensor; w2: torch.Tensor; w3: torch.Tensor  # clip w  # noqa: E702
    safe: torch.Tensor       # bool, ops/setup.py coverage_safe

    @property
    def num_triangles(self) -> int:
        return self.a0.shape[0]


# Order of the 24 planar rows the front-end kernel writes.
FE_ROWS = ("a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1", "c2",
           "zx", "zy", "zc", "abs_d", "inv_area", "area2",
           "bx0", "by0", "bx1", "by1", "valid", "w1", "w2", "w3", "safe")
_INT_ROWS = ("bx0", "by0", "bx1", "by1")
_BOOL_ROWS = ("valid", "safe")


def corner_cols(corners):
    """[T, 3, 3] corners -> ((x1, y1, z1), (x2, ..), (x3, ..)) columns."""
    return tuple((corners[:, c, 0], corners[:, c, 1], corners[:, c, 2])
                 for c in range(3))


def attr_corner_cols(values):
    """[T, 3, A] per-corner values -> list over A of (v1, v2, v3) columns."""
    return [(values[:, 0, i], values[:, 1, i], values[:, 2, i])
            for i in range(values.shape[-1])]


def _front_math(corners_c, mm, width: int, height: int, *,
                cull_backfaces: bool, front_face_ccw: bool,
                near_eps: float):
    """The front-end body over [T] columns (plain version of the kernel).

    corners_c: three (X, Y, Z) column triplets; mm: the 16 transform
    scalars, row-major. Returns the 24 columns named by :data:`FE_ROWS`
    (bbox as exact-integer floats, valid/safe as bools).
    """
    wf = float(width)
    hf = float(height)
    xs, ys, zs, ws = [], [], [], []
    near_ok = None
    for (X, Y, Z) in corners_c:
        cx = mm[0] * X + mm[1] * Y + mm[2] * Z + mm[3]
        cy = mm[4] * X + mm[5] * Y + mm[6] * Z + mm[7]
        cz = mm[8] * X + mm[9] * Y + mm[10] * Z + mm[11]
        cw = mm[12] * X + mm[13] * Y + mm[14] * Z + mm[15]
        ok = cw > near_eps
        near_ok = ok if near_ok is None else (near_ok & ok)
        wg = torch.where(cw == 0.0, 1.0, cw)
        u = (cx / wg) * 0.5 + 0.5
        v = (cy / wg) * -0.5 + 0.5
        xs.append(round_half_away(u * wf))
        ys.append(round_half_away(v * hf))
        zs.append(cz / wg)
        ws.append(cw)
    cols = setup_columns(xs, ys, zs, width, height,
                         cull_backfaces=cull_backfaces,
                         front_face_ccw=front_face_ccw, extra_valid=near_ok)
    return (*cols[:-1], *ws, cols[-1])


def planar_setup_from_rows(rows: torch.Tensor) -> PlanarSetup:
    """[24, T] float32 front-end rows -> PlanarSetup (casts the bbox rows
    to int32 and the flag rows to bool; both are exact)."""
    cols = {}
    for name, row in zip(FE_ROWS, rows.unbind(0)):
        if name in _INT_ROWS:
            row = row.to(torch.int32)
        elif name in _BOOL_ROWS:
            row = row != 0.0
        cols[name] = row
    return PlanarSetup(**cols)


def _front_inputs(corners_c, transform):
    """The kernel's inputs: [9, T] float32 corner rows and the [16]
    row-major transform on their device."""
    cols = torch.stack([c for corner in corners_c for c in corner]).to(
        torch.float32).contiguous()
    m = transform.to(dtype=torch.float32, device=cols.device).reshape(16)
    return cols, m.contiguous()


def planar_front(corners_c, transform, width: int, height: int, *,
                 cull_backfaces: bool = False, front_face_ccw: bool = True,
                 near_eps: float = CLIP_EPS) -> PlanarSetup:
    """Vertex transform + triangle setup, fully planar.

    corners_c: per-corner (x, y, z) [T] columns from :func:`corner_cols`.
    On CUDA tensors this launches the front-end kernel at every T; on CPU
    tensors it runs the plain version (ops/frontend_kernel.py).
    """
    from .frontend_kernel import fe_kernel
    return planar_setup_from_rows(fe_kernel(
        *_front_inputs(corners_c, transform), width, height,
        cull_backfaces=cull_backfaces, front_face_ccw=front_face_ccw,
        near_eps=near_eps))


def planar_front_table(corners_c, transform, attrs, width: int, height: int,
                       *, cull_backfaces: bool = False,
                       front_face_ccw: bool = True,
                       near_eps: float = CLIP_EPS,
                       perspective: bool = False):
    """:func:`planar_front` and the stream table of ``attrs`` in one pass.

    attrs: list over the channels of per-corner (v1, v2, v3) [T] columns,
    as :func:`attribute_plane_cols` takes them. Returns (PlanarSetup,
    table, n_channels, poison), the values of
    ``stream_table_planar(ps, attribute_plane_cols(ps, attrs))`` beside
    the setup; with ``perspective``, of
    ``perspective_chan_vals(attrs, ps)`` instead of ``attrs`` (the
    channels over w, then 1/w: n_channels is one more). On CUDA tensors
    one launch of the front-end kernel writes the setup's rows and the
    table; on CPU tensors the plain versions run (ops/frontend_kernel.py).
    """
    from .frontend_kernel import fe_table_kernel
    cols, m = _front_inputs(corners_c, transform)
    vals = (torch.stack([v for chan in attrs for v in chan]).to(
        torch.float32).contiguous() if attrs else
        cols.new_empty((0, cols.shape[1])))
    rows, table = fe_table_kernel(
        cols, m, vals, width, height, cull_backfaces=cull_backfaces,
        front_face_ccw=front_face_ccw, near_eps=near_eps,
        perspective=perspective)
    return (planar_setup_from_rows(rows), table, len(attrs) + perspective,
            _stream_poison(table.shape[1], table.device))


def to_setup(ps: PlanarSetup) -> TriangleSetup:
    """Re-pack the planar columns into the array TriangleSetup (the same
    values, pure layout), for the ``reference`` and ``pallas`` backends."""
    row = lambda *cols: torch.stack(cols, dim=-1)
    return TriangleSetup(
        coef=torch.stack([row(ps.a0, ps.a1, ps.a2), row(ps.b0, ps.b1, ps.b2),
                          row(ps.c0, ps.c1, ps.c2)], dim=-2),
        zplane=row(ps.zx, ps.zy, ps.zc), inv_area=ps.inv_area,
        bbox=row(ps.bx0, ps.by0, ps.bx1, ps.by1), valid=ps.valid,
        area2=ps.area2, safe=ps.safe)


def from_setup(setup: TriangleSetup) -> PlanarSetup:
    """The columns of an array TriangleSetup as a PlanarSetup (the same
    values, pure layout; the inverse of :func:`to_setup`), so that a
    setup from ops/setup.py (the near-plane clip's [2T] triangles) takes
    the binned path: the bin build, :func:`bbox_table`,
    :func:`stream_table_planar` and :func:`pack_records_planar` read these
    columns. A TriangleSetup carries no clip-space w: w1-w3 are NaN (the
    clip path makes its perspective channels before the setup,
    ops/shading.py ``perspective_vertex_attrs``)."""
    col = lambda c, k: setup.coef[:, c, k]
    w_corners = torch.full((setup.num_triangles, 3), float("nan"),
                           device=setup.coef.device)
    return PlanarSetup(
        a0=col(0, 0), a1=col(0, 1), a2=col(0, 2), b0=col(1, 0),
        b1=col(1, 1), b2=col(1, 2), c0=col(2, 0), c1=col(2, 1),
        c2=col(2, 2), zx=setup.zplane[:, 0], zy=setup.zplane[:, 1],
        zc=setup.zplane[:, 2],
        abs_d=torch.where(setup.valid, torch.abs(setup.area2), 0.0),
        inv_area=setup.inv_area, area2=setup.area2, bx0=setup.bbox[:, 0],
        by0=setup.bbox[:, 1], bx1=setup.bbox[:, 2], by1=setup.bbox[:, 3],
        valid=setup.valid, w1=w_corners[:, 0], w2=w_corners[:, 1],
        w3=w_corners[:, 2], safe=setup.safe)


def as_planar(setup) -> PlanarSetup:
    """A PlanarSetup as it is; a TriangleSetup through :func:`from_setup`."""
    return setup if isinstance(setup, PlanarSetup) else from_setup(setup)


def corner_w(ps: PlanarSetup) -> torch.Tensor:
    """[T, 3] clip-space w of each corner."""
    return torch.stack([ps.w1, ps.w2, ps.w3], dim=-1)


def perspective_chan_vals(chan_vals, ps: PlanarSetup):
    """Per-corner channel columns -> the same over each corner's clip w,
    and a last channel 1/w (``1 / w``, with 1 where w is 0). attr/w and
    1/w are affine in screen space; the perspective plan of the fused
    epilogue divides the first by the second per pixel (ops/shading.py
    ``perspective_epilogue``)."""
    iw = tuple(1.0 / torch.where(w == 0.0, 1.0, w)
               for w in (ps.w1, ps.w2, ps.w3))
    out = [(v1 * iw[0], v2 * iw[1], v3 * iw[2]) for (v1, v2, v3) in chan_vals]
    out.append(iw)
    return out


def attribute_plane_cols(ps: PlanarSetup, chan_vals):
    """Per-corner attribute columns -> affine plane columns (x, y, const
    per channel), ``(coef . vals) * inv_area``."""
    cols = []
    for (v1, v2, v3) in chan_vals:
        cols.append((ps.a0 * v1 + ps.a1 * v2 + ps.a2 * v3) * ps.inv_area)
        cols.append((ps.b0 * v1 + ps.b1 * v2 + ps.b2 * v3) * ps.inv_area)
        cols.append((ps.c0 * v1 + ps.c1 * v2 + ps.c2 * v3) * ps.inv_area)
    return cols


def attribute_planes(ps: PlanarSetup, vals) -> torch.Tensor:
    """[T, 3, A] per-corner values -> [T, 3A] plane columns, the values of
    :func:`attribute_plane_cols` (the same operations in the same order)
    in a few [T, A] operations rather than six per plane."""
    t, _, a = vals.shape
    inv = ps.inv_area[:, None]
    rows = ((ps.a0, ps.a1, ps.a2), (ps.b0, ps.b1, ps.b2),
            (ps.c0, ps.c1, ps.c2))
    planes = [((k0[:, None] * vals[:, 0] + k1[:, None] * vals[:, 1])
               + k2[:, None] * vals[:, 2]) * inv for k0, k1, k2 in rows]
    return torch.stack(planes, dim=-1).reshape(t, 3 * a)


def _stream_poison(n_cols: int, device) -> torch.Tensor:
    """The poison stream row (c0 = c1 = -1: outside everywhere; zc = +inf;
    id -1), a shared constant (``device.constant``), read only."""
    return constant((0.0,) * 4 + (-1.0, -1.0) + (0.0,) * 3
                    + (float("inf"), -1.0) + (0.0,) * (n_cols - 11), device)


def stream_table_planar(ps: PlanarSetup, plane_cols):
    """[T, 11 + 3A] combined kernel stream table.

    Columns: a0 a1 | b0 b1 | c0 c1 | |D| | zx zy zc | id | planes.
    plane_cols: the 3A plane columns (:func:`attribute_plane_cols`) or
    their [T, 3A] stack (:func:`attribute_planes`). Invalid triangles get
    the poison row. Returns (table, n_channels, poison).
    """
    t = ps.num_triangles
    a3 = (plane_cols.shape[1] if isinstance(plane_cols, torch.Tensor)
          else len(plane_cols))
    if a3 % 3:
        raise ValueError("plane columns come in (x, y, const) triplets")
    ids = torch.arange(t, dtype=torch.float32, device=ps.a0.device)
    cols = [ps.a0, ps.a1, ps.b0, ps.b1, ps.c0, ps.c1, ps.abs_d,
            ps.zx, ps.zy, ps.zc, torch.where(ps.valid, ids, -1.0)]
    if isinstance(plane_cols, torch.Tensor):
        table = torch.cat([torch.stack(cols, dim=1), plane_cols], dim=1)
    else:
        table = torch.stack(cols + list(plane_cols), dim=1)
    poison = _stream_poison(11 + a3, table.device)
    table = torch.where(ps.valid[:, None], table, poison)
    return table, a3 // 3, poison


def bbox_table(ps: PlanarSetup) -> torch.Tensor:
    """[T, 4] int32 (x0, y0, x1, y1): each triangle's inclusive pixel
    bbox, indexed by triangle id (the bin walk's cull, ops/binning.py)."""
    return torch.stack([ps.bx0, ps.by0, ps.bx1, ps.by1], dim=1)


def pack_records_planar(ps: PlanarSetup, chunk: int):
    """[T_pad, 16] raster records of the planar front-end (bbox in
    columns 10-13, id in column 14): ops/rasterize_kernel.py
    ``pack_records`` of :func:`to_setup`."""
    return pack_records(to_setup(ps), chunk)
