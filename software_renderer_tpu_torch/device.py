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


# Tensors of host values, built once per (values, dtype, device).
_constants: dict = {}


def _frozen(values):
    """``values`` with every list a tuple, as a dictionary key."""
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


def resolved(device) -> torch.device:
    """``device`` as a ``torch.device``, a card without an index as the
    current one: one key for every spelling of a device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """A tensor of ``values`` (a number or nested sequence) on
    ``device``, built at the first call and shared by every later one,
    so that a frame copies nothing from the host: a copy from pageable
    host memory waits on the host and cannot be captured into a CUDA
    graph (parallel/frame_graph.py). Callers must not write to it."""
    device = resolved(device)
    key = (_frozen(values), dtype, device)
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def on_device(value, device, dtype=torch.float32) -> torch.Tensor:
    """``value`` (a tensor, number or sequence) as a ``dtype`` tensor on
    ``device``. Host values bound for a card (numbers, sequences, CPU
    tensors that need no gradient) come from :func:`constant`; a tensor
    already on a card is cast in place of a copy."""
    device = torch.device(device)
    if isinstance(value, torch.Tensor):
        if (device.type == "cpu" or value.device.type != "cpu"
                or value.requires_grad):
            return value.to(dtype=dtype, device=device)
        value = value.tolist()
    if device.type == "cpu":
        return torch.as_tensor(value, dtype=dtype)
    return constant(value, device, dtype)
