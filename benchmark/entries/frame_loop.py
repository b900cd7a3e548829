"""The viewer: ``utils.display.FrameLoop(scene_fn, transform_fn)
.frame()`` over precomputed transforms (time advancing 1 / fps a frame
from a start drawn from the seed), each frame's color through
``to_rgba8`` into a pinned host buffer the harness owns, waited for
before the next (closed loop, one viewer). Reports ``frame_ms_p95``."""

import time

import numpy as np
import torch

from benchlib import program
from benchlib.drivers import Driver as Base, Item, near_cuts, p95, rng


class Driver(Base):
    KEYS = {"max_frames", "warmup_frames", "compare_frames", "keep_within",
            "trace_frames", "stack_frames"}

    def setup(self):
        t = self.traffic
        r = rng(self.seed, 1)
        cam = self.cfg["camera"]
        self.period = self.cam.period_s(cam)
        self.t_start = float(r.uniform(0.0, self.period))
        self.n = t["max_frames"]
        self.ts = self.camera(np.arange(self.n), self.t_start)
        # Compared: the frame of the first pass whose clip cuts the most
        # triangles and frames drawn from the seed among the quarter of
        # the pass's frames that cut the most (inside config 4's cloud,
        # for about half a turn the camera looks out and draws next to
        # nothing).
        span = min(self.cycle_frames(), t.get("keep_within", self.n),
                   self.n)
        with self.reference_work():
            cuts = near_cuts(self.reference_scene(), self.ts[:span])
            order = torch.argsort(cuts, descending=True).tolist()
        top = order[1:max(span // 4, t["compare_frames"])]
        self.keep = {order[0]} | set(int(k) for k in r.choice(
            top, t["compare_frames"] - 1, replace=False))
        sr = program.package()
        self.to_rgba8 = sr.to_rgba8
        self.render = sr.render
        display = program.module("utils.display")
        rp0 = self.rp(self.ts[0])
        self.tick = 0
        self.loop = display.FrameLoop(lambda t: rp0,
                                      transform_fn=self._transform)
        self.pinned = torch.empty((self.cfg["height"], self.cfg["width"], 4),
                                  dtype=torch.uint8,
                                  pin_memory=self.device.type == "cuda")
        self.tick = self.n - t["warmup_frames"]
        for _ in range(t["warmup_frames"]):
            self._frame()
        self.tick = 0
        self.routes = program.module("parallel.frame_graph").routes

    def t_of(self, j):
        """The camera's time at frame ``j`` of the loop."""
        return np.mod(self.t_start + j / self.cfg["camera"]["fps"],
                      self.period)

    def _transform(self, time_s):
        return self.ts[self.tick % self.n]

    def _frame(self):
        fb = self.loop.frame()
        img = self.to_rgba8(fb.color)
        if self.device.type == "cuda":
            self.pinned.copy_(img, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        else:
            self.pinned.copy_(img)
        self.tick += 1
        return fb

    def step(self):
        j = self.attempted
        self.attempted += 1
        t0 = time.perf_counter()
        fb = self._frame()
        t1 = time.perf_counter()
        self.item_s.append(t1 - t0)
        self.items_done += 1
        if j in self.keep:
            self.kept.append(Item(
                f"frame {j} (t = {float(self.t_of(j)):.4f} s)",
                self.ts[j % self.n], self.pinned.clone(), fb.depth))
        return 1

    def metrics(self, window_s):
        return {"frame_ms_p95": p95(self.item_s) * 1e3}

    def check_items(self, scene):
        return self.kept

    def trace_fn(self):
        k = self.traffic["trace_frames"]

        def run():
            for _ in range(k):
                self._frame()
        return run, k

    def stack_fn(self):
        k = self.traffic["stack_frames"]
        ts = [self.ts[(self.tick + i) % self.n] for i in range(k)]
        rps = [self.rp(t) for t in ts]
        return (lambda: [self.render(r) for r in rps]), k, torch.stack(ts)
