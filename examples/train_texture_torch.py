#!/usr/bin/env python
"""Appearance optimization with the PyTorch port: recover a texture from
rendered targets.

Differentiable shading, a (frames, rows) device mesh with the per-shard
gradients summed (parallel/sharding.py), and checkpoint/resume
(utils/checkpoint.py):

  python examples/train_texture_torch.py --steps 30 --out out/train
  python examples/train_texture_torch.py --steps 30 --out out/train --resume

Runs on every card of the machine; ``--device cpu`` runs on the CPU.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import software_renderer_tpu_torch as srt  # noqa: E402
from software_renderer_tpu_torch.models import scenes  # noqa: E402
from software_renderer_tpu_torch.ops import transforms as tf  # noqa: E402
from software_renderer_tpu_torch.parallel.batch import render_batch  # noqa: E402
from software_renderer_tpu_torch.parallel.sharding import (  # noqa: E402
    make_mesh, texture_train_step)
from software_renderer_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from software_renderer_tpu_torch.utils.image_io import write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--lr", type=float, default=150.0)
    ap.add_argument("--out", default="out/train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: every card)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.device is None:
        n_dev = torch.cuda.device_count()
        n_rows = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        mesh = make_mesh(n_dev // n_rows, n_rows)
    else:
        mesh = make_mesh(1, 1, [args.device])
    device = mesh.devices[0][0]
    print(f"device mesh: {mesh.shape}")

    rp = scenes.config2_textured_cube(0.0, width=args.size,
                                      height=args.size, device=device)
    rp = dataclasses.replace(rp, light=None)  # pure texture recovery
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device=device))
    transforms = torch.stack([
        rp.transform @ tf.rotation_matrix(tf.quat_from_axis_angle(axis, t))
        for t in torch.linspace(0.0, 2.0, args.frames, device=device)])

    targets = render_batch(rp, transforms, backend="reference").color

    ckpt = os.path.join(args.out, "texture.npz")
    step0 = 0
    if args.resume and os.path.exists(ckpt):
        arrays, meta = load_checkpoint(ckpt)
        tex = torch.as_tensor(arrays["texture"], device=device)
        step0 = int(meta.get("step", 0))
        print(f"resumed from step {step0}")
    else:
        tex = torch.full_like(rp.texture.data, 0.5)

    for step in range(step0, step0 + args.steps):
        tex, loss = texture_train_step(tex, rp, transforms, targets, mesh,
                                       lr=args.lr, backend="reference")
        if step % 5 == 0 or step == step0 + args.steps - 1:
            print(f"step {step}: loss {float(loss):.6f}")
            save_checkpoint(ckpt, {"texture": tex}, meta={"step": step + 1})

    def rgba(t):
        return srt.to_rgba8(torch.cat([t, torch.ones_like(t[..., :1])], -1))

    write_png(os.path.join(args.out, "recovered.png"), rgba(tex))
    write_png(os.path.join(args.out, "target_texture.png"),
              rgba(rp.texture.data))
    print(f"wrote {args.out}/recovered.png")


if __name__ == "__main__":
    main()
