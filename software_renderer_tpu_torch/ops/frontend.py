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

from .clip import CLIP_EPS
from .rasterize_kernel import pack_records
from .setup import TriangleSetup, coverage_safe
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
    x1, x2, x3 = xs
    y1, y2, y3 = ys
    z1, z2, z3 = zs

    d = (x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3)
    finite = torch.ones_like(d, dtype=torch.bool)
    for col in (x1, y1, z1, x2, y2, z2, x3, y3, z3):
        finite = finite & torch.isfinite(col)
    degenerate = ~finite | (d == 0.0)
    s = torch.where(d < 0.0, -1.0, 1.0)
    abs_d = torch.abs(d)
    inv_area = torch.where(degenerate, 0.0,
                           1.0 / torch.where(degenerate, 1.0, abs_d))
    a0 = (y2 - y3) * s
    b0 = (x3 - x2) * s
    a1 = (y3 - y1) * s
    b1 = (x1 - x3) * s
    c0 = -(a0 * x3 + b0 * y3)
    c1 = -(a1 * x3 + b1 * y3)
    a2 = -(a0 + a1)
    b2 = -(b0 + b1)
    c2 = abs_d - c0 - c1
    zx = (a0 * z1 + a1 * z2 + a2 * z3) * inv_area
    zy = (b0 * z1 + b1 * z2 + b2 * z3) * inv_area
    zc = (c0 * z1 + c1 * z2 + c2 * z3) * inv_area

    min_x = torch.minimum(torch.minimum(x1, x2), x3)
    max_x = torch.maximum(torch.maximum(x1, x2), x3)
    min_y = torch.minimum(torch.minimum(y1, y2), y3)
    max_y = torch.maximum(torch.maximum(y1, y2), y3)
    offscreen = (max_x < 0.0) | (min_x > wf) | (max_y < 0.0) | (min_y > hf)
    clean = lambda a: torch.where(torch.isfinite(a), a, 0.0)
    bx0 = torch.clamp(clean(torch.floor(min_x)), 0, width - 1)
    by0 = torch.clamp(clean(torch.floor(min_y)), 0, height - 1)
    bx1 = torch.clamp(clean(torch.ceil(max_x)), 0, width - 1)
    by1 = torch.clamp(clean(torch.ceil(max_y)), 0, height - 1)

    valid = ~degenerate & ~offscreen & near_ok
    if cull_backfaces:
        valid = valid & ((d > 0.0) if front_face_ccw else (d < 0.0))

    # Invalid fills: e = (-1, -1, -1) through the constant columns, depth
    # plane -> +inf, inv_area -> 0. where(), never a multiply by the mask:
    # a multiply would keep the NaN of non-finite corners.
    a0 = torch.where(valid, a0, 0.0)
    a1 = torch.where(valid, a1, 0.0)
    a2 = torch.where(valid, a2, 0.0)
    b0 = torch.where(valid, b0, 0.0)
    b1 = torch.where(valid, b1, 0.0)
    b2 = torch.where(valid, b2, 0.0)
    c0 = torch.where(valid, c0, -1.0)
    c1 = torch.where(valid, c1, -1.0)
    c2 = torch.where(valid, c2, -1.0)
    zx = torch.where(valid, zx, 0.0)
    zy = torch.where(valid, zy, 0.0)
    zc = torch.where(valid, zc, float("inf"))
    inv_area = torch.where(valid, inv_area, 0.0)
    safe = coverage_safe(x1, y1, x2, y2, x3, y3, a0, b0, a1, b1, abs_d,
                         width, height) | ~valid
    return (a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc,
            torch.where(valid, abs_d, 0.0), inv_area, d, bx0, by0, bx1, by1,
            valid, ws[0], ws[1], ws[2], safe)


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
                       near_eps: float = CLIP_EPS):
    """:func:`planar_front` and the stream table of ``attrs`` in one pass.

    attrs: list over the channels of per-corner (v1, v2, v3) [T] columns,
    as :func:`attribute_plane_cols` takes them. Returns (PlanarSetup,
    table, n_channels, poison), the values of
    ``stream_table_planar(ps, attribute_plane_cols(ps, attrs))`` beside
    the setup. On CUDA tensors one launch of the front-end kernel writes
    the setup's rows and the table; on CPU tensors the plain versions run
    (ops/frontend_kernel.py).
    """
    from .frontend_kernel import fe_table_kernel
    cols, m = _front_inputs(corners_c, transform)
    vals = (torch.stack([v for chan in attrs for v in chan]).to(
        torch.float32).contiguous() if attrs else
        cols.new_empty((0, cols.shape[1])))
    rows, table = fe_table_kernel(
        cols, m, vals, width, height, cull_backfaces=cull_backfaces,
        front_face_ccw=front_face_ccw, near_eps=near_eps)
    return (planar_setup_from_rows(rows), table, len(attrs),
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


def attribute_plane_cols(ps: PlanarSetup, chan_vals):
    """Per-corner attribute columns -> affine plane columns (x, y, const
    per channel), ``(coef . vals) * inv_area``."""
    cols = []
    for (v1, v2, v3) in chan_vals:
        cols.append((ps.a0 * v1 + ps.a1 * v2 + ps.a2 * v3) * ps.inv_area)
        cols.append((ps.b0 * v1 + ps.b1 * v2 + ps.b2 * v3) * ps.inv_area)
        cols.append((ps.c0 * v1 + ps.c1 * v2 + ps.c2 * v3) * ps.inv_area)
    return cols


def _stream_poison(n_cols: int, device) -> torch.Tensor:
    # Slices, so that each write is a fill a CUDA graph can capture.
    poison = torch.zeros(n_cols, dtype=torch.float32, device=device)
    poison[4:6] = -1.0           # c0 = c1 = -1: outside everywhere
    poison[9:10] = float("inf")  # zc = +inf
    poison[10:11] = -1.0         # id = -1
    return poison


def stream_table_planar(ps: PlanarSetup, plane_cols):
    """[T, 11 + 3A] combined kernel stream table.

    Columns: a0 a1 | b0 b1 | c0 c1 | |D| | zx zy zc | id | planes. Invalid
    triangles get the poison row. Returns (table, n_channels, poison).
    """
    t = ps.num_triangles
    a3 = len(plane_cols)
    if a3 % 3:
        raise ValueError("plane columns come in (x, y, const) triplets")
    ids = torch.arange(t, dtype=torch.float32, device=ps.a0.device)
    cols = [ps.a0, ps.a1, ps.b0, ps.b1, ps.c0, ps.c1, ps.abs_d,
            ps.zx, ps.zy, ps.zc, torch.where(ps.valid, ids, -1.0)]
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
