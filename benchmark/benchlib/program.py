"""The system under test: the port's public constructors and entry
points, fed with the benchmark's own inputs.

Only this module, the entry points' drivers (benchmark/entries/) and the
per-layer metric readers name the program. It receives the generators'
arrays through ``mesh_from_numpy``, ``Texture`` and ``Light`` and never
builds a scene of its own. Everything the render pass says comes from
the configuration (benchlib/inputs.py refuses a key nothing reads).
"""

from __future__ import annotations

import importlib
import os
import sys

import torch

from .inputs import FLAT_COLOR

PACKAGE = "software_renderer_tpu_torch"
# The program reads its texture tail's route from here at import.
ROUTE_VAR = "SR_TEX_WINDOWED"


def package():
    return importlib.import_module(PACKAGE)


def module(name: str):
    """``software_renderer_tpu_torch.<name>``."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def enable_build_cache():
    """Keep the kernel library in the package's fixed ``_build/`` inside
    the checkout: only a checkout's first run builds it."""
    return module("utils.timing").enable_compile_cache()


def select_sampler_route(route: str) -> str:
    """Run the texture tail's ``route`` (a configuration's
    ``sampler_route``; "default" leaves the program's own), before the
    program is imported; returns the route the program runs."""
    imported = f"{PACKAGE}.ops.texture" in sys.modules
    if not imported:
        if route == "default":
            os.environ.pop(ROUTE_VAR, None)
        else:
            os.environ[ROUTE_VAR] = route
    got = sampler_route()
    if route != "default" and got != route:
        raise ValueError(f"the program runs sampler route {got!r}, not the "
                         f"configuration's {route!r}")
    return got


def render_pass(inputs, cfg, transform, device):
    """The port's RenderPass of the benchmark's inputs
    (benchlib/inputs.py) under ``transform`` [4, 4], as the
    configuration ``cfg`` draws it."""
    sr = package()
    s = inputs.arrays
    mesh = sr.mesh_from_numpy(s.positions, s.indices, colors=s.colors,
                              normals=s.normals, uvs=s.uvs, device=device)
    light = texture = None
    if inputs.light is not None:
        light = sr.Light(**{k: v.to(device) for k, v in inputs.light.items()})
    if inputs.texture is not None:
        tx = cfg["texture"]
        texture = sr.Texture(data=inputs.texture.to(device),
                             filter=tx["filter"], wrap=tx["wrap"])
    return sr.RenderPass(
        mesh=mesh, transform=transform, width=cfg["width"],
        height=cfg["height"], shading=cfg["shading"], texture=texture,
        cull_backfaces=cfg["cull_backfaces"],
        perspective_correct=cfg["perspective_correct"],
        clip_near=cfg["clip_near"], light=light,
        model=inputs.model.to(device),
        flat_color=torch.tensor(FLAT_COLOR, device=device))


def sampler_route() -> str:
    """The texture tail's route the program runs (SR_TEX_WINDOWED)."""
    return module("ops.texture").TEX_WINDOWED
