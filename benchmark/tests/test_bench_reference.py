"""The plain reference against the port's CPU path (its plain versions)
at small sizes: coverage and depth exact, colors within the check's
share of differing 8-bit values."""

import numpy as np
import pytest
import torch

from conftest import small_cell
from benchlib import compare, inputs, program
from benchlib import reference as ref


# What a configuration may ask of the render pass besides config 4's:
# each reaches the program and the reference alike.
VARIANTS = {
    "config4": {},
    "phong": {"shading": "phong", "texture": None},
    "vertex": {"shading": "vertex", "texture": None},
    "flat": {"shading": "flat", "texture": None},
    "unlit": {"light": None},
    "bilinear_clamp": {"texture": {"generator": "checkerboard", "size": 64,
                                   "tiles": 4, "filter": "bilinear",
                                   "wrap": "clamp"}},
}


def variant(cfg, name):
    for k, v in VARIANTS[name].items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    return cfg


@pytest.mark.parametrize("name,ticks,start,var", [
    ("config4_orbit.batch64", [0, 120, 240, 600], 0.0, "config4"),
    ("config4_inside.view", [0, 30, 60], 3.0, "config4"),
] + [("config4_orbit.batch64", [120, 600], 0.0, v) for v in VARIANTS
     if v != "config4"] + [("config4_inside.view", [30], 3.0, "phong")])
def test_reference_equals_port_cpu(name, ticks, start, var):
    cell = small_cell(name)
    cfg = variant(cell.config, var)
    inp = inputs.make(cfg, 11)
    assert inp.arrays.triangles < 4096
    scene = inp.reference_scene("cpu")
    sr = program.package()
    tally = compare.FrameTally()
    for t in inputs.transforms(cfg, np.asarray(ticks), start):
        t = torch.from_numpy(t)
        fb = sr.render(program.render_pass(inp, cfg, t, "cpu"))
        r = ref.render(scene, t, cfg)
        tally.add(fb.color, fb.depth, r.color, r.depth)
    n = tally.numbers()
    assert n["covered_px"] > 0
    assert n["coverage_diff_px"] == 0
    assert n["depth_diff_px"] == 0
    assert n["rgb8_off_share"] <= cell.limits["rgb8_off_share"]


def test_clip_cuts_triangles():
    """Inside config 4's full scene the camera cuts triangles at the
    near plane, and the clip keeps a piece of some."""
    cfg = small_cell("config4_inside.view").config
    cfg["scene"]["target_triangles"] = 100_000    # geometry only: cheap
    inp = inputs.make(cfg, 11)
    scene = inp.reference_scene("cpu")
    t = torch.from_numpy(inputs.transforms(cfg, np.asarray([0]), 0.0)[0])
    g = ref.geometry(scene["positions"], scene["indices"], t, cfg["width"],
                     cfg["height"], clip_near=True)
    tris = scene["indices"].reshape(-1, 3).long()
    w = ref.clip_space(scene["positions"][tris], t)[..., 3]
    cut = (w.amin(1) < ref.CLIP_EPS) & (w.amax(1) >= ref.CLIP_EPS)
    assert int(cut.sum()) > 0
    assert bool(g.valid[: tris.shape[0]][cut].any())


def test_visibility_blocks_agree():
    """The visibility pass gives the same buffers in blocks of any size."""
    cfg = small_cell("config4_orbit.batch64").config
    inp = inputs.make(cfg, 5)
    scene = inp.reference_scene("cpu")
    t = torch.from_numpy(inputs.transforms(cfg, np.asarray([240]))[0])
    g = ref.geometry(scene["positions"], scene["indices"], t, cfg["width"],
                     cfg["height"])
    st = ref.setup(g, cfg["width"], cfg["height"])
    d0, i0 = ref.visibility(st, cfg["width"], cfg["height"])
    d1, i1 = ref.visibility(st, cfg["width"], cfg["height"], block=997)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


@pytest.mark.parametrize("filt,wrap,other", [
    ("nearest", "repeat", ("bilinear", "repeat")),
    ("bilinear", "clamp", ("bilinear", "repeat")),
])
def test_filter_and_wrap_reach_both_sides(filt, wrap, other):
    """On random texels the program's frame is far nearer the
    reference's under the configuration's filter and wrap than under
    another. (Nearest sampling flips texels where an interpolated u or v
    lands on a texel's edge, as this scene's do along whole triangles,
    so its share of differing values is not held to the frame limit.)"""
    cell = small_cell("config4_orbit.batch64")
    cfg = cell.config
    cfg["texture"].update(filter=filt, wrap=wrap)
    inp = inputs.make(cfg, 11)
    inp.texture = torch.rand(inp.texture.shape,
                             generator=torch.Generator().manual_seed(3))
    scene = inp.reference_scene("cpu")
    ocfg = dict(cfg, texture=dict(cfg["texture"], filter=other[0],
                                  wrap=other[1]))
    sr = program.package()
    same, diff = compare.FrameTally(), compare.FrameTally()
    for t in inputs.transforms(cfg, np.asarray([120, 600])):
        t = torch.from_numpy(t)
        fb = sr.render(program.render_pass(inp, cfg, t, "cpu"))
        for tally, c in ((same, cfg), (diff, ocfg)):
            r = ref.render(scene, t, c)
            tally.add(fb.color, fb.depth, r.color, r.depth)
    a, b = same.numbers(), diff.numbers()
    assert a["coverage_diff_px"] == 0 and a["depth_diff_px"] == 0
    assert b["rgb8_off_share"] > 0
    assert a["rgb8_off_share"] * 3 < b["rgb8_off_share"], (a, b)


@pytest.mark.parametrize("where,key,value", [
    (None, "shading", "toon"),
    (None, "precision", "bfloat16"),
    (None, "sampler_route", "2"),
    (None, "unread", 1),
    ("texture", "filter", "trilinear"),
    ("texture", "wrap", "mirror"),
    ("texture", "unread", 1),
    ("scene", "generator", "no_such_scene"),
    ("scene", "unread", 1),
    ("camera", "kind", "no_such_camera"),
    ("camera", "unread", 1),
    (None, "light", "sunset"),
])
def test_unsupported_configuration_is_refused(where, key, value):
    cfg = small_cell("config4_orbit.batch64").config
    (cfg if where is None else cfg[where])[key] = value
    with pytest.raises(ValueError):
        inputs.validate(cfg)


def test_texture_goes_with_textured_shading():
    cfg = small_cell("config4_orbit.batch64").config
    cfg["shading"] = "phong"
    with pytest.raises(ValueError):
        inputs.validate(cfg)
    del cfg["texture"]
    inputs.validate(cfg)


def test_cut_pixels_mark_near_plane_pieces():
    """The tile share leaves out exactly the pixels won by a piece of a
    triangle the near plane cuts: some inside config 4's cloud, none in
    the orbit (which clips nothing)."""
    inside = small_cell("config4_inside.view").config
    inside["scene"]["target_triangles"] = 100_000
    scene = inputs.make(inside, 11).reference_scene("cpu")
    # Frame 77 of the turn: a surface crossing the eye plane fills part
    # of the screen (at frame 0 every cut piece lands off screen).
    t = torch.from_numpy(inputs.transforms(inside, np.asarray([77]), 0.0)[0])
    r = ref.render(scene, t, inside)
    cut = ref.cut_pixels(scene, t, r.ids)
    tris = scene["indices"].reshape(-1, 3).long()
    w = ref.clip_space(scene["positions"][tris], t)[..., 3]
    cut_tris = torch.nonzero((w < ref.CLIP_EPS).any(1)).flatten()
    won = r.ids[r.ids >= 0]
    want = (won >= tris.shape[0]) | torch.isin(won, cut_tris)
    assert bool(cut.any()) and torch.equal(cut[r.ids >= 0], want)
    assert not bool(cut[r.ids < 0].any())
    orbit = small_cell("config4_orbit.batch64").config
    scene = inputs.make(orbit, 11).reference_scene("cpu")
    t = torch.from_numpy(inputs.transforms(orbit, np.asarray([120]))[0])
    r = ref.render(scene, t, orbit)
    assert not bool(ref.cut_pixels(scene, t, r.ids).any())
