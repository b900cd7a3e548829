"""``render(rp)`` per frame, the camera's frames from a start drawn from
the seed, one frame a call, each frame's color waited for (closed loop,
one caller). Reports ``call_ms_p95``."""

import time

import numpy as np
import torch

from benchlib import program
from benchlib.drivers import (Driver as Base, Item, nearest_approach, p95,
                              rng, sync)


class Driver(Base):
    KEYS = {"warmup_calls", "keep_within", "compare_frames", "trace_frames"}

    def setup(self):
        t = self.traffic
        self.n = self.cycle_frames()
        self.ts = self.camera(np.arange(self.n))
        r = rng(self.seed, 1)
        self.start = int(r.integers(self.n))
        span = min(t["keep_within"], self.n)
        self.render = program.package().render
        self.rps = [self.rp(x) for x in self.ts]
        # Kept: the call, among the first ``span``, whose frame comes
        # nearest the eye, and calls drawn from the seed among the rest.
        first = (self.start + torch.arange(span)) % self.n
        with self.reference_work():
            near = int(torch.argmin(nearest_approach(
                self.reference_scene(), self.ts[first.to(self.ts.device)])))
        rest = [k for k in range(span) if k != near]
        self.keep = {near} | set(int(k) for k in r.choice(
            rest, t["compare_frames"] - 1, replace=False))
        for k in range(t["warmup_calls"]):
            self.render(self.rps[(self.start - 1 - k) % self.n])

    def step(self):
        j = self.attempted
        self.attempted += 1
        rp = self.rps[(self.start + j) % self.n]
        t0 = time.perf_counter()
        fb = self.render(rp)
        t1 = time.perf_counter()
        sync(self.device)
        t2 = time.perf_counter()
        self.host_s.append(t1 - t0)
        self.item_s.append(t2 - t0)
        self.items_done += 1
        if j in self.keep:
            f = (self.start + j) % self.n
            self.kept.append(Item(f"frame {f} (call {j})", self.ts[f],
                                  fb.color, fb.depth))
        return 1

    def metrics(self, window_s):
        return {"call_ms_p95": p95(self.item_s) * 1e3}

    def check_items(self, scene):
        return self.kept

    def trace_fn(self):
        k = self.traffic["trace_frames"]
        j0 = self.attempted
        rps = [self.rps[(self.start + j0 + i) % self.n] for i in range(k)]

        def run():
            for r in rps:
                self.render(r)
                sync(self.device)
        return run, k
