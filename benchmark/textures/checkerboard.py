"""The program's ``ops/texture.py`` ``checkerboard``: ``tiles`` x
``tiles`` squares of white and dark grey on a ``size`` x ``size``
texture, frozen in benchlib/scene.py."""

from benchlib import scene as sc

KEYS = {"generator", "size", "tiles", "filter", "wrap"}


def make(params: dict):
    """[size, size, 3] float32 (numpy)."""
    return sc.checkerboard(params["size"], params["tiles"])
