"""``parallel.batch.render_batch`` over calls of ``batch`` transforms,
the camera's frames at a ``stride``, each call one frame later than the
one before, from a start drawn from the seed; the output stays on the
device, the harness synchronises after each call and reads one
checksum of its color. Reports ``frames_per_s``."""

import time

import numpy as np
import torch

from benchlib import program
from benchlib.drivers import Driver as Base, Item, nearest_approach, rng


class Driver(Base):
    KEYS = {"batch", "stride", "warmup_calls", "keep_within",
            "compare_frames", "stack_frames"}

    def setup(self):
        t = self.traffic
        n = self.cycle_frames()
        self.n, self.batch, self.stride = n, t["batch"], t["stride"]
        if self.batch * self.stride > n:
            raise ValueError("a call's frames must not wrap the camera's")
        ts = self.camera(np.arange(n))
        self.ts = torch.cat([ts, ts])
        r = rng(self.seed, 1)
        self.start = int(r.integers(n))
        self.keep_call = int(r.integers(t["keep_within"]))
        self.rp0 = self.rp(self.ts[0])
        self.render_batch = program.module("parallel.batch").render_batch
        self.routes = program.module("parallel.frame_graph").routes
        for _ in range(t["warmup_calls"]):
            self._call(self.start - 1)

    def _frames(self, call):
        s = call % self.n
        return s, self.ts[s:s + self.batch * self.stride:self.stride]

    def _call(self, call):
        return self.render_batch(self.rp0, self._frames(call)[1])

    def step(self):
        j = self.attempted
        self.attempted += 1
        t0 = time.perf_counter()
        fb = self._call(self.start + j)
        t1 = time.perf_counter()
        float(fb.color.sum())          # the checksum; waits for the call
        t2 = time.perf_counter()
        self.host_s.append(t1 - t0)
        self.item_s.append(t2 - t0)
        self.items_done += self.batch
        # The first call stands in until the kept call comes.
        if j in (0, self.keep_call):
            self.kept_fb, self.kept_start = fb, (self.start + j) % self.n
        return self.batch

    def metrics(self, window_s):
        return {"frames_per_s": self.items_done / window_s}

    def check_items(self, scene):
        """Frame 0 of the kept call (rendered eagerly and captured), the
        frame that comes nearest the eye, and frames drawn from the seed
        (replayed)."""
        s, ts = self._frames(self.kept_start)
        r = rng(self.seed, 2)
        near = int(torch.argmin(nearest_approach(scene, ts)))
        pick = [0, near] + [int(k) for k in r.permutation(self.batch)]
        pick = list(dict.fromkeys(pick))[:self.traffic["compare_frames"]]
        out = []
        for k in pick:
            out.append(Item(f"frame {(s + k * self.stride) % self.n} "
                            f"(call frame {k})", ts[k],
                            self.kept_fb.color[k], self.kept_fb.depth[k]))
        self.kept_fb = None
        return out

    def trace_fn(self):
        """One call of the traffic, for the traced stretch."""
        call = self.start + self.attempted
        return (lambda: self._call(call)), self.batch

    def stack_fn(self):
        """The same frames, rendered eagerly, for the stack attribution."""
        render = program.package().render
        _, ts = self._frames(self.start + self.attempted)
        k = self.traffic["stack_frames"]
        rps = [self.rp(t) for t in ts[:k]]
        return (lambda: [render(r) for r in rps]), k, ts[:k]
