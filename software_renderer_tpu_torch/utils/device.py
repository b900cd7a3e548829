"""Device discovery, memory statistics and the host-device sync.

Counterpart of the JAX package's utils/device.py for torch devices. The
device an entry point builds on when given none is the package's
device.py; this module describes devices and waits for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import or_default


@dataclasses.dataclass
class DeviceInfo:
    platform: str                  # "gpu" or "cpu"
    kind: str                      # torch.cuda.get_device_name, or "cpu"
    index: int
    memory_bytes: Optional[int]    # the card's total memory; None on CPU

    @staticmethod
    def query(device=None) -> "DeviceInfo":
        """Describe ``device``, by default ``cuda:0`` (raises without a
        card unless ``device="cpu"`` is asked for)."""
        d = or_default(device)
        if d.type == "cpu":
            return DeviceInfo(platform="cpu", kind="cpu", index=0,
                              memory_bytes=None)
        index = d.index if d.index is not None else 0
        return DeviceInfo(platform="gpu",
                          kind=torch.cuda.get_device_name(index),
                          index=index,
                          memory_bytes=torch.cuda.mem_get_info(index)[1])


def memory_in_use(device=None) -> Optional[int]:
    """Bytes the caching allocator holds in tensors on ``device`` (the
    card by default); None for the CPU."""
    d = or_default(device)
    return None if d.type == "cpu" else torch.cuda.memory_allocated(d)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def block_on(tree):
    """Wait until the work behind every leaf of ``tree`` is done and
    return ``tree``: each CUDA tensor's device is synchronized, and each
    ``torch.cuda.Event`` waited for (a leaf on the CPU is ready already).
    The host-device sync of the frame loop and the timers: once per frame
    or batch, never inside a frame."""
    devices = set()
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            devices.add(leaf.device)
        elif isinstance(leaf, torch.cuda.Event):
            leaf.synchronize()
    for d in devices:
        torch.cuda.synchronize(d)
    return tree
