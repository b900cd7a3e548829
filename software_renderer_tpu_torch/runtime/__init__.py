"""Native host runtime: C++ OBJ parsing and PNG encoding through ctypes.

Counterpart of the JAX package's runtime/ with its own copy of the C++
source (sr_runtime.cpp). The library is built with g++ at first use into
the package's build directory (``_cuda.BUILD_DIR``, ``_build/`` unless
utils/timing.py ``enable_compile_cache`` moves it), under a file name
that carries a hash of the source and the flags, so an edited source
builds anew. This is host I/O around the device path, not a kernel.

A failed build is logged once with the compiler's output (utils/log.py)
and the entry points then take their Python versions (utils/image_io.py,
models/obj.py); :func:`available` says whether the native library is in
use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import _cuda
from ..utils.log import get_logger

SRC = Path(__file__).resolve().parent / "sr_runtime.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)

log = get_logger("runtime")
_lock = threading.Lock()
_lib = None
_build_error = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return _cuda.BUILD_DIR / f"libsr_runtime_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp),
                          *LIBS], capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    """The loaded library, built at first use; None once a build or load
    has failed (logged the first time)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            log.warning("native runtime unavailable, using the Python "
                        "encoder and OBJ reader: %s", _build_error)
            return None
        lib.sr_write_png.restype = ctypes.c_int
        lib.sr_write_png.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.sr_obj_load.restype = ctypes.c_void_p
        lib.sr_obj_load.argtypes = [ctypes.c_char_p]
        lib.sr_obj_counts.restype = None
        lib.sr_obj_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.sr_obj_fill.restype = None
        lib.sr_obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.sr_obj_free.restype = None
        lib.sr_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and in use."""
    return _load() is not None


def write_png(path: str, image) -> None:
    """Native PNG encode of a uint8 [H, W] or [H, W, 1|3|4] image (a
    tensor is copied to the host once); other images, or no native
    library, go through utils.image_io.write_png."""
    from ..utils.image_io import host_array, write_png as py_write_png
    img = np.ascontiguousarray(host_array(image))
    lib = _load()
    if lib is None or img.dtype != np.uint8 or img.ndim not in (2, 3):
        return py_write_png(path, img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rc = lib.sr_write_png(os.fsencode(path), img.ctypes.data, w, h, c)
    if rc != 0:
        raise IOError(f"sr_write_png failed with code {rc}")


def read_png(path: str) -> np.ndarray:
    """PNG decode (the Python zlib path; see utils.image_io)."""
    from ..utils.image_io import read_png as py_read_png
    return py_read_png(path)


def load_obj(path: str, abs_normal_colors: bool = True, device=None):
    """Native OBJ load into a Mesh on ``device`` (the card unless the
    caller passes ``device="cpu"``); without the native library,
    models.obj.load_obj. A file with no faces raises ValueError."""
    from ..device import or_default
    from ..models.mesh import mesh_from_numpy
    from ..models.obj import compute_vertex_normals, load_obj as py_load

    device = or_default(device)
    lib = _load()
    if lib is None:
        return py_load(path, abs_normal_colors=abs_normal_colors,
                       device=device)
    handle = lib.sr_obj_load(os.fsencode(path))
    if not handle:
        raise IOError(f"cannot open or parse OBJ file {path!r}")
    try:
        nv = ctypes.c_int32()
        ni = ctypes.c_int32()
        lib.sr_obj_counts(handle, ctypes.byref(nv), ctypes.byref(ni))
        positions = np.empty((nv.value, 3), np.float32)
        normals = np.empty((nv.value, 3), np.float32)
        uvs = np.empty((nv.value, 2), np.float32)
        indices = np.empty((ni.value,), np.int32)
        lib.sr_obj_fill(handle, positions.ctypes.data, normals.ctypes.data,
                        uvs.ctypes.data, indices.ctypes.data)
    finally:
        lib.sr_obj_free(handle)
    if ni.value == 0:
        # The Python reader's contract (models/obj.py): a readable file
        # with no face data raises, never an empty mesh.
        raise ValueError(f"{path!r} contains no OBJ face data "
                         f"({nv.value} vertices, 0 faces)")
    if not np.any(normals):
        normals = compute_vertex_normals(positions, indices.reshape(-1, 3))
    colors = np.abs(normals) if abs_normal_colors else np.ones_like(positions)
    return mesh_from_numpy(positions, indices, colors=colors,
                           normals=normals, uvs=uvs, device=device)
