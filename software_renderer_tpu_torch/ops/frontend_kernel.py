"""Wrappers of the CUDA front-end kernel (csrc/fe.cu).

Replaces the TPU kernel ``_fe_kernel`` (software_renderer_tpu/ops/
frontend_kernel.py:42) and, in :func:`fe_table_kernel`, the XLA stages
beside it that turn the corner attributes into the [T, 11 + 3A] stream
table the bin walk reads. The TPU kernel runs the shared planar math over
[64, 128] blocks of triangles; here one thread computes one triangle's 24
output columns from its 9 corner coordinates and the 16 transform
scalars, and with attributes also its table row. With the perspective
flag it also takes the place of JAX's ``perspective_chan_vals`` (ops/
frontend.py:298, an XLA stage there): the table's channels are the
corner values over the corner's clip w, which the kernel has just
computed, and a last 1/w channel.

What bounds it on the card: memory traffic, about 370 bytes a triangle
with rows and table at 8 channels. Built from torch ops, the planes and
the table take ~150 launches a frame; the kernel writes them in the same
pass as the rows, staging each block's table rows in shared memory so
that they leave in 16-byte chunks (csrc/fe.cu).

Numerics: the library is built with ``--fmad=false`` and IEEE division
and square root, and the kernel evaluates ``_front_math``'s operations in
its order, with NaN-propagating min/max like ``torch.minimum``, and the
planes as ``attribute_plane_cols`` does, so its rows and table equal the
plain versions' bit for bit on the same card.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .clip import CLIP_EPS
from .frontend import (FE_ROWS, _front_math, attribute_plane_cols,
                       perspective_chan_vals, planar_setup_from_rows,
                       stream_table_planar)

# Channels of the table the kernel writes (a perspective-correct plan
# adds 1/w to config 4's 8).
MAX_CHANNELS = 9


def fe_plain(cols: torch.Tensor, m: torch.Tensor, width: int, height: int,
             *, cull_backfaces: bool = False, front_face_ccw: bool = True,
             near_eps: float = CLIP_EPS) -> torch.Tensor:
    """Plain version: [9, T] corner rows + [16] transform -> [24, T]."""
    corners_c = tuple((cols[3 * c], cols[3 * c + 1], cols[3 * c + 2])
                      for c in range(3))
    outs = _front_math(corners_c, m, width, height,
                       cull_backfaces=cull_backfaces,
                       front_face_ccw=front_face_ccw, near_eps=near_eps)
    return torch.stack([o.to(torch.float32) for o in outs])


def fe_table_plain(cols: torch.Tensor, m: torch.Tensor, attrs: torch.Tensor,
                   width: int, height: int, *, perspective: bool = False,
                   **kw):
    """Plain version of the table kernel: :func:`fe_plain`, then
    ``stream_table_planar(ps, attribute_plane_cols(ps, ...))`` of its
    setup, of ``perspective_chan_vals(..., ps)`` with ``perspective``.
    Returns (rows [24, T], table [T, 11 + 3A], A + 1 channels with
    ``perspective``)."""
    rows = fe_plain(cols, m, width, height, **kw)
    ps = planar_setup_from_rows(rows)
    vals = [tuple(attrs[3 * i:3 * i + 3])
            for i in range(attrs.shape[0] // 3)]
    if perspective:
        vals = perspective_chan_vals(vals, ps)
    return rows, stream_table_planar(ps, attribute_plane_cols(ps, vals))[0]


def fe_kernel(cols: torch.Tensor, m: torch.Tensor, width: int, height: int,
              *, cull_backfaces: bool = False, front_face_ccw: bool = True,
              near_eps: float = CLIP_EPS) -> torch.Tensor:
    """[9, T] float32 corner rows (x1 y1 z1 x2 .. z3) + [16] row-major
    transform -> [24, T] float32 rows in :data:`frontend.FE_ROWS` order.

    CPU tensors run :func:`fe_plain`; CUDA tensors launch the kernel.
    """
    if cols.device.type == "cpu":
        return fe_plain(cols, m, width, height,
                        cull_backfaces=cull_backfaces,
                        front_face_ccw=front_face_ccw, near_eps=near_eps)
    return _card_fe(cols, m, None, width, height, cull_backfaces,
                    front_face_ccw, near_eps, False)[0]


def fe_table_kernel(cols: torch.Tensor, m: torch.Tensor, attrs: torch.Tensor,
                    width: int, height: int, *, cull_backfaces: bool = False,
                    front_face_ccw: bool = True,
                    near_eps: float = CLIP_EPS, perspective: bool = False):
    """:func:`fe_kernel` and the stream table in one pass.

    attrs: [3A, T] float32 corner-attribute columns (v1, v2, v3 of each
    channel), A <= MAX_CHANNELS. Returns (rows [24, T], table [T, 11 + 3A]
    float32: a0 a1 b0 b1 c0 c1 |D| zx zy zc id, then each channel's x, y
    and const planes; the poison row where a triangle is invalid).
    perspective: the channels are the values over each corner's clip w,
    then 1/w (``frontend.perspective_chan_vals``): the table has
    11 + 3 (A + 1) columns, A + 1 <= MAX_CHANNELS.

    CPU tensors run :func:`fe_table_plain`; CUDA tensors launch the
    kernel.
    """
    if cols.device.type == "cpu":
        return fe_table_plain(cols, m, attrs, width, height,
                              cull_backfaces=cull_backfaces,
                              front_face_ccw=front_face_ccw,
                              near_eps=near_eps, perspective=perspective)
    return _card_fe(cols, m, attrs, width, height, cull_backfaces,
                    front_face_ccw, near_eps, perspective)


def _card_fe(cols, m, attrs, width, height, cull_backfaces, front_face_ccw,
             near_eps, perspective):
    """Check the CUDA inputs and launch the kernel (with the table when
    ``attrs`` is given); returns (rows, table or None)."""
    _cuda.require(cols, torch.float32, "cols", ndim=2)
    _cuda.require(m, torch.float32, "m", device=cols.device, shape=(16,))
    if cols.shape[0] != 9:
        raise ValueError(f"cols must be [9, T], got {tuple(cols.shape)}")
    t = cols.shape[1]
    dev = cols.device
    table = None
    a = 0
    if attrs is not None:
        _cuda.require(attrs, torch.float32, "attrs", device=dev, ndim=2)
        a = attrs.shape[0] // 3
        n_max = MAX_CHANNELS - perspective
        if attrs.shape != (3 * a, t) or a > n_max:
            raise ValueError(f"attrs must be [3A, {t}] with A <= {n_max}"
                             f"{' (and 1/w)' if perspective else ''}, got "
                             f"{tuple(attrs.shape)}")
        table = torch.empty((t, 11 + 3 * (a + perspective)),
                            dtype=torch.float32, device=dev)
    elif perspective:
        raise ValueError("the perspective channels need a table (attrs)")
    out = torch.empty((len(FE_ROWS), t), dtype=torch.float32, device=dev)
    if t:
        lib = _cuda.lib()
        _cuda.launches["fe"] += 1
        if perspective:
            _cuda.launches["fe_persp"] += 1
        _cuda.check(lib.sr_fe(
            cols.data_ptr(), t, m.data_ptr(),
            None if attrs is None else attrs.data_ptr(), a,
            int(perspective), width, height,
            int(cull_backfaces), int(front_face_ccw), near_eps,
            out.data_ptr(), None if table is None else table.data_ptr(),
            _cuda.stream_of(cols)))
    return out, table
