"""Leveled logging.

Counterpart of the JAX package's utils/log.py: stdlib logging under one
namespaced logger whose level comes from the environment (``SR_TPU_LOG``,
default WARNING).
"""

from __future__ import annotations

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
