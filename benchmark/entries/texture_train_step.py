"""Texture fitting: ``parallel.sharding.texture_train_step`` on the
camera's ``frames`` (in an order drawn from the seed) from flat texels,
against targets that the reference renders under texels drawn from the
seed. The first ``first_steps`` steps run in set-up through the window's
own call; the window goes on from them with the same object. The check
follows every step, set-up's and the window's, with the reference.
Reports ``step_ms``."""

import time

import torch

from benchlib import compare, program
from benchlib import reference as ref
from benchlib.drivers import Driver as Base, rng


class Driver(Base):
    KEYS = {"frames", "lr", "flat", "first_steps", "trace_steps",
            "layout_seed"}

    def setup(self):
        t = self.traffic
        if self.inputs.texture is None:
            raise ValueError("texture fitting needs a textured configuration")
        # The same frames for every seed (their coverage sets the cost
        # of the texels' scatter), in an order drawn from the seed.
        r = rng(self.seed, 1)
        self.frames = [int(f) for f in r.permutation(t["frames"])]
        self.ts = self.camera(self.frames)
        self.lr = t["lr"]
        self.first = t["first_steps"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 63))
        tex = self.inputs.texture
        self.true_tex = torch.rand(tex.shape, generator=gen,
                                   device=self.device)
        h, w = self.cfg["height"], self.cfg["width"]
        with self.reference_work(), torch.no_grad():
            scene = self.reference_scene()
            self.targets = torch.stack([
                ref.shade(ref.frame_surface(scene, x, self.cfg),
                          self.true_tex, h, w, *ref.texture_mode(self.cfg))
                for x in self.ts])
            del scene
        self.tex0 = torch.full(tex.shape, t["flat"], device=self.device)
        self.rp0 = self.rp(self.ts[0])
        self.step_fn = program.module("parallel.sharding").texture_train_step
        self.tex = self.tex0
        # Every step's loss, set-up's and the window's; the texels after
        # each of set-up's steps; ``tex`` is the texels after the last.
        self.losses, self.states = [], []
        for _ in range(self.first):
            self.tex, loss = self._step(self.tex)
            self.losses.append(float(loss))
            self.states.append(self.tex)

    def _step(self, tex):
        return self.step_fn(tex, self.rp0, self.ts, self.targets,
                            lr=self.lr)

    def step(self):
        self.attempted += 1
        t0 = time.perf_counter()
        self.tex, loss = self._step(self.tex)
        self.losses.append(float(loss))
        t1 = time.perf_counter()
        self.item_s.append(t1 - t0)
        self.items_done += 1
        return 1

    def metrics(self, window_s):
        return {"step_ms": window_s / self.items_done * 1e3}

    def trace_fn(self):
        k = self.traffic["trace_steps"]

        def run():
            tex = self.tex
            for _ in range(k):
                tex, loss = self._step(tex)
            float(loss)
        return run, k

    def compared(self, log):
        """Every step's numbers against the reference's as many steps
        from the same flat texels, targets and frames."""
        ref_losses, ref_states = compare.reference_train(self)
        log(f"compared {len(self.losses)} steps ({self.first} in set-up)")
        return compare.program_train_numbers(self, ref_losses,
                                             ref_states), True
