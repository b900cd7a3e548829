"""Leveled logging and coarse counters.

Counterpart of the JAX package's utils/log.py: stdlib logging under one
namespaced logger whose level comes from the environment (``SR_TPU_LOG``,
default WARNING), and a counters registry the frame loop bumps (frames
rendered, written, presented).
"""

from __future__ import annotations

import collections
import logging
import os

_LOGGER = logging.getLogger("software_renderer_tpu_torch")
if not _LOGGER.handlers:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    _LOGGER.addHandler(handler)
    _LOGGER.setLevel(os.environ.get("SR_TPU_LOG", "WARNING").upper())
    _LOGGER.propagate = False


def get_logger(name: str | None = None) -> logging.Logger:
    return _LOGGER if name is None else _LOGGER.getChild(name)


# Coarse metrics: counters the render loop bumps (frames rendered, frames
# written, frames presented, ...).
counters: collections.Counter = collections.Counter()


def bump(name: str, value: int = 1) -> None:
    counters[name] += value
