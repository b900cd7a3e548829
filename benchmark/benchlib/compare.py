"""The comparison that decides ``correct``: the numbers compared and
their limits (benchmark/limits/<cell>.json).

Frames (every frame cell): what the program produced, as RGBA8 (its own
``to_rgba8`` pixels in the viewer, the harness's quantization of the
float color elsewhere, with the same rounding) and its depth, against
the reference's frame at the same transform:

* ``coverage_diff_px``: pixels covered on one side only (exact);
* ``depth_diff_px``: pixels covered on both sides whose depth differs
  (exact: the depth plane is evaluated in the same float32 operations);
* ``rgb8_off_share``: share of the RGB values of pixels covered on both
  sides whose 8-bit value differs;
* ``rgb8_tile_off8_share``: in the worst 16 x 16 tile of any compared
  frame, the share of its pixels whose RGB differs by more than
  :data:`TILE_LEVELS` levels, over the pixels covered on both sides
  whose winner the near plane does not cut (a tile counts with at
  least :data:`TILE_MIN_PX` of them): a fault confined to the overflow
  path's winners (a few thousand pixels of a frame's million) moves the
  whole frame's share too little, and a tile's a great deal, where
  rounding moves a pixel by a level or two. Pieces cut at the near
  plane are left out: their attribute-over-w planes, from corners at
  w = 1e-6, round far from the reference over whole tiles of a
  close-up, and the whole frame's share judges them.

Logged beside them and not compared (they swing from seed to seed by
nature): ``rgb8_max_diff``, the widest difference in levels, and
``rgb8_gross_px``, pixels off by more than :data:`GROSS` levels.

Texture fitting: the program's steps, set-up's first ones and the
window's, against the reference's from the same flat texture, targets
and frames, as many steps:

* ``loss_gap``: the largest relative gap of a first step's loss;
* ``grad_norm_gap``: relative gap of the norms of the first gradient
  (``(texels before - texels after) / lr`` of step 1);
* ``change_norm_gap``: relative gap of the norms of the texels' change
  over the first steps;
* ``window_loss_gap``: the largest relative gap of a window step's loss;
* ``window_change_gap``: relative gap of the norms of the texels'
  change over every step, the window's last included.
"""

from __future__ import annotations

import torch

from . import reference as ref

def rgba8(color):
    """float RGBA -> uint8, round half to even after clamping to [0, 1]."""
    if color.dtype == torch.uint8:
        return color
    return torch.round(torch.clamp(color.float(), 0, 1) * 255).to(
        torch.uint8)


# A color difference past this many 8-bit levels counts as gross.
GROSS = 32
# Tiles of the local share, the covered pixels a tile needs to count,
# and the difference in 8-bit levels past which a pixel counts there.
TILE = 16
TILE_MIN_PX = 64
TILE_LEVELS = 8


class FrameTally:
    """Accumulates the frame numbers over compared frames."""

    def __init__(self):
        self.cov = self.depth = self.off = self.vals = 0
        self.maxd = self.gross = self.covered = 0
        self.tile = 0.0

    def add(self, color, depth, ref_color, ref_depth, cut=None):
        """One frame against the reference's; ``cut``: [H, W] bool, the
        pixels the tile share leaves out."""
        p, r = rgba8(color).to(ref_color.device), rgba8(ref_color)
        cp, cr = p[..., 3] > 0, r[..., 3] > 0
        both = cp & cr
        self.cov += int((cp != cr).sum())
        if depth is not None:
            d = depth.to(ref_depth.device)
            self.depth += int((both & (d != ref_depth)).sum())
        full = (p[..., :3].int() - r[..., :3].int()).abs()
        diff = full[both]
        judged = both if cut is None else both & ~cut
        self.tile = max(self.tile, tile_share(
            (full > TILE_LEVELS).any(-1), judged))
        self.covered += int(both.sum())
        self.gross += int((diff > GROSS).any(-1).sum())
        self.off += int((diff > 0).sum())
        self.vals += diff.numel()
        if diff.numel():
            self.maxd = max(self.maxd, int(diff.max()))

    def numbers(self):
        return {"coverage_diff_px": self.cov, "depth_diff_px": self.depth,
                "rgb8_off_share": self.off / max(self.vals, 1),
                "rgb8_tile_off8_share": self.tile,
                "rgb8_gross_px": self.gross, "rgb8_max_diff": self.maxd,
                "covered_px": self.covered}


def tile_share(hit, both, tile=TILE, min_px=TILE_MIN_PX):
    """The largest share of ``hit`` pixels ([H, W] bool) among the pixels
    covered on both sides (``both``), over the ``tile`` x ``tile`` tiles
    with at least ``min_px`` of those."""
    h, w = both.shape
    pad = (0, -w % tile, 0, -h % tile)

    def tiles(x):
        x = torch.nn.functional.pad(x.float()[None, None], pad)[0, 0]
        return x.reshape(x.shape[0] // tile, tile, x.shape[1] // tile,
                         tile).sum((1, 3))
    n, k = tiles(both), tiles(hit & both)
    ok = n >= min_px
    return float((k[ok] / n[ok]).max()) if bool(ok.any()) else 0.0


def frame_numbers(items, scene, cfg):
    """The frame numbers of ``items`` (drivers.Item) against the
    reference, one frame at a time."""
    tally = FrameTally()
    for it in items:
        r = ref.render(scene, it.transform, cfg)
        tally.add(it.color, it.depth, r.color, r.depth,
                  ref.cut_pixels(scene, it.transform, r.ids))
        del r
    return tally.numbers()


def control_numbers(items, scene, cfg, dtype=None, **kw):
    """The control: the reference in ``dtype`` (by default the nearest
    precision below the configuration's; ``kw``: or in ``shade_dtype``
    for the shading alone) in the program's place, against the
    reference, at the same frames."""
    dtype = dtype or ref.CONTROL[cfg["precision"]]
    tally = FrameTally()
    for it in items:
        r = ref.render(scene, it.transform, cfg)
        c = ref.render(scene, it.transform, cfg, dtype=dtype, **kw)
        tally.add(c.color, c.depth, r.color, r.depth,
                  ref.cut_pixels(scene, it.transform, r.ids))
        del r, c
    return tally.numbers()


def _gap(a, b):
    """|a - b| relative to b."""
    return abs(a - b) / max(abs(b), 1e-30)


def train_numbers(losses, states, final, tex0, ref_losses, ref_states, lr,
                  first):
    """The training numbers of the program's steps (``losses``: every
    step's; ``states``: the texels after each of the ``first`` steps;
    ``final``: the texels after the last) against the reference's
    (``ref_losses``, ``ref_states``: as many steps)."""
    norm = lambda x: float(torch.linalg.vector_norm(x.detach()))
    k, n = first, len(losses)
    window = [_gap(a, b) for a, b in zip(losses[k:], ref_losses[k:n])]
    return {"loss_gap": max(_gap(a, b) for a, b in zip(losses[:k],
                                                        ref_losses)),
            "grad_norm_gap": _gap(norm((tex0 - states[0]) / lr),
                                  norm((tex0 - ref_states[0]) / lr)),
            "change_norm_gap": _gap(norm(states[k - 1] - tex0),
                                    norm(ref_states[k - 1] - tex0)),
            "window_loss_gap": max(window) if window else 0.0,
            "window_change_gap": _gap(norm(final - tex0),
                                      norm(ref_states[n - 1] - tex0))}


def reference_train(driver, dtype=torch.float32, frames=None):
    """The reference's steps on the driver's frames (or the ``frames``
    slice of them), targets and flat texture, as many as the program
    made: (losses, texels after each step)."""
    cfg = driver.cfg
    frames = frames or slice(None)
    scene = driver.reference_scene()
    if dtype != torch.float32:
        scene = {k: (v.to(dtype) if torch.is_tensor(v)
                     and v.is_floating_point() else v)
                 for k, v in scene.items()}
    surfs = [ref.frame_surface(scene, t, cfg, dtype=dtype)
             for t in driver.ts[frames]]
    return ref.train_steps(surfs, [t.to(dtype) for t in
                                   driver.targets[frames]],
                           driver.tex0.to(dtype), driver.lr,
                           len(driver.losses), cfg["height"], cfg["width"],
                           ref.texture_mode(cfg))


def program_train_numbers(driver, ref_losses, ref_states):
    """The program's training numbers (a driver of
    ``entries/texture_train_step.py`` after its window)."""
    return train_numbers(driver.losses, driver.states, driver.tex,
                         driver.tex0, ref_losses, ref_states, driver.lr,
                         driver.first)


def judge(numbers: dict, limits: dict):
    """(all compared numbers within their limits, [(name, value, limit,
    ok)] of the numbers that have a limit)."""
    rows = [(k, numbers[k], lim, numbers[k] <= lim)
            for k, lim in limits.items()]
    return all(ok for *_, ok in rows), rows
