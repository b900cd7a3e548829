"""Carry a scene across from the JAX package.

:func:`arrays_of` reads the leaves of a JAX ``RenderPass`` as numpy
arrays (duck-typed: it only reads attributes and calls ``np.asarray``, so
this module imports nothing of JAX), and :func:`render_pass_from_numpy`
builds this package's ``RenderPass`` from them. With the two, a test
feeds both packages the same scene. These functions put their tensors on
the card unless the caller passes ``device="cpu"`` (device.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import or_default
from .models.mesh import Mesh
from .ops.frontend import PlanarSetup
from .ops.setup import TriangleSetup
from .ops.shading import Light
from .ops.texture import Texture
from .render import RenderPass

_MESH = ("positions", "indices", "colors", "normals", "uvs")
_LIGHT = ("direction", "color", "ambient", "specular", "shininess")
STATIC_FIELDS = ("width", "height", "primitive", "shading",
                 "cull_backfaces", "perspective_correct", "clip_near")


def arrays_of(rp) -> dict:
    """Leaves of a RenderPass as numpy arrays (absent leaves left out):
    ``positions``, ``indices``, ``colors``, ``normals``, ``uvs``,
    ``transform``, ``model``, ``flat_color``, ``texture``, and
    ``light_<field>`` for the Light's fields."""
    out = {}
    for name in _MESH:
        if getattr(rp.mesh, name) is not None:
            out[name] = np.asarray(getattr(rp.mesh, name))
    for name in ("transform", "model", "flat_color"):
        if getattr(rp, name) is not None:
            out[name] = np.asarray(getattr(rp, name))
    if rp.texture is not None:
        out["texture"] = np.asarray(rp.texture.data)
    if rp.light is not None:
        for name in _LIGHT:
            out[f"light_{name}"] = np.asarray(getattr(rp.light, name))
    return out


def static_fields_of(rp) -> dict:
    """The static fields of a RenderPass (and its texture's filter and
    wrap) as keyword arguments of :func:`render_pass_from_numpy`."""
    out = {name: getattr(rp, name) for name in STATIC_FIELDS}
    if rp.texture is not None:
        out["texture_filter"] = rp.texture.filter
        out["texture_wrap"] = rp.texture.wrap
    return out


def render_pass_from_numpy(arrays: dict, *, device=None,
                           texture_filter: str = "bilinear",
                           texture_wrap: str = "repeat",
                           **static_fields) -> RenderPass:
    """Build a RenderPass on ``device`` from the arrays of
    :func:`arrays_of` and the static fields of :func:`static_fields_of`."""
    device = or_default(device)

    def t(name, dtype=torch.float32):
        a = arrays.get(name)
        if a is None:
            return None
        return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)

    mesh = Mesh(positions=t("positions"),
                indices=t("indices", torch.int32).reshape(-1),
                colors=t("colors"), normals=t("normals"), uvs=t("uvs"))
    light = None
    if "light_direction" in arrays:
        light = Light(*(t(f"light_{name}") for name in _LIGHT))
    texture = None
    if "texture" in arrays:
        texture = Texture(data=t("texture"), filter=texture_filter,
                          wrap=texture_wrap)
    extra = {}
    if "flat_color" in arrays:
        extra["flat_color"] = t("flat_color")
    return RenderPass(mesh=mesh, transform=t("transform"), light=light,
                      texture=texture, model=t("model"), **extra,
                      **static_fields)


def _fields_from_numpy(cls, obj, device):
    device = or_default(device)
    return cls(**{
        f.name: torch.from_numpy(np.array(getattr(obj, f.name))).to(device)
        for f in dataclasses.fields(cls)})


def planar_setup_from_numpy(ps, *, device=None) -> PlanarSetup:
    """This package's PlanarSetup from any object with a PlanarSetup's
    fields as arrays (a JAX ``PlanarSetup`` included), so that both
    packages can run on one shared front-end result."""
    return _fields_from_numpy(PlanarSetup, ps, device)


def triangle_setup_from_numpy(setup, *, device=None) -> TriangleSetup:
    """This package's TriangleSetup from any object with a TriangleSetup's
    fields as arrays (a JAX ``TriangleSetup`` included), so that both
    packages rasterize one shared setup."""
    return _fields_from_numpy(TriangleSetup, setup, device)
