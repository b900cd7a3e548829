"""The device an entry point builds on when its caller names none.

Counterpart of the JAX package's utils/device.py. The port's scene
functions, mesh builders (``mesh_from_numpy``, the shapes, the OBJ
reader), ``checkerboard``, ``Light.default`` and converters build on the
card unless asked for the CPU; without a card they raise rather than fall
back, so a run that meant to use the kernels never quietly takes the
plain versions. The transforms and the ops follow the device of their
arguments instead.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device=\"cpu\" to run the plain PyTorch "
            "versions on the CPU")
    return torch.device("cuda")


def or_default(device) -> torch.device:
    """``device`` itself, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)
