"""Checkpoint and resume: arrays in a ``.npz`` beside a ``.json`` of
metadata.

Counterpart of the JAX package's utils/checkpoint.py with the same
layout, so a checkpoint saved by either package loads in the other.
Tensors are copied to the host and saved as numpy arrays; loading gives
numpy arrays, which the caller moves where it wants them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .image_io import host_array


def save_checkpoint(path: str, arrays: dict, meta: dict | None = None
                    ) -> None:
    """arrays: name -> tensor or array; meta: small json-able dict. The
    arrays are written to a temporary file first and renamed into place."""
    arrays = {k: host_array(v) for k, v in arrays.items()}
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f)


def load_checkpoint(path: str):
    """Returns (arrays dict of np arrays, meta dict or {})."""
    with np.load(path) as data:
        arrays = dict(data)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return arrays, meta
