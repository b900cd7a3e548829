"""Build, load and launch the package's CUDA kernels (csrc/*.cu).

Each source compiles in its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded through ``ctypes`` at first use. The library's
file name carries a hash of the sources, so an edited source builds anew
and a stale library is never loaded. Nothing here runs at import: the CPU
tests import every module on machines without ``nvcc`` or a card.

Build flags: ``--fmad=false`` keeps every multiply and add separately
rounded, as PyTorch's op-by-op plain versions round them, and no fast-math
flag is given, so division and square root stay IEEE (``-prec-div``,
``-prec-sqrt``). On the card the kernels then equal their plain versions
bit for bit in coverage, triangle id and depth.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Where the built libraries go (utils/timing.py enable_compile_cache).
BUILD_DIR = DEFAULT_BUILD_DIR
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

# Kernel launches since the last reset_launches(), one plain integer per
# kernel. A wrapper adds one exactly where it launches its kernel;
# "fused_seeded" counts the seeded launches among the "fused" ones, and
# the "_persp" counts the perspective instances among "fe" and "fused"
# (and "fused_seeded").
launches = {"fe": 0, "fe_persp": 0, "fused": 0, "fused_seeded": 0,
            "fused_persp": 0, "fused_persp_seeded": 0, "visibility_merge": 0,
            "resolve_merge": 0, "visibility": 0, "binned_vis": 0,
            "resolve": 0, "sampler": 0, "window_lookup": 0,
            "take_along_axis": 0, "tail": 0, "clip_front": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sr_fe": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P),
    "sr_fused": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    "sr_visibility_scratch": (_I, _I, _I, _P),
    "sr_visibility_merge": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                            _P, _P),
    "sr_resolve_merge": (_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                         _I, _P),
    "sr_visibility": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "sr_binned_vis": (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                      _P, _P),
    "sr_resolve": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "sr_sampler": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P),
    "sr_window_lookup": (_P, _I, _I, _P, _P, _P, _I, _P, _P),
    "sr_take_along_axis": (_P, _I, _I, _P, _I, _P, _P),
    "sr_capture_nodes": (_P, _I, _P),
    "sr_tail": (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _I, _P),
    "sr_clip_front": (_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _I,
                      _P, _I, _I, _I, _F, _P, _P, _P, _P, _P),
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the library unless it exists; return its
    path. ``verbose`` adds ``-Xptxas -v`` and prints the compiler output
    (registers, shared memory and spills per kernel)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp.with_suffix(f".{s.stem}.o") for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c",
         "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    try:
        logs = [p.communicate()[0] for p in procs]
        failed = [log for p, log in zip(procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(logs), flush=True)
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.sr_error_string.argtypes = (ctypes.c_int,)
        handle.sr_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        raise RuntimeError(
            f"CUDA error {err}: {lib().sr_error_string(err).decode()}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device``, queried once per
    card (a kernel with a grid sized for the card, not the frame)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


def capture_nodes(stream: "torch.cuda.Stream", typed: bool = False) -> int:
    """Nodes of the CUDA graph that ``stream`` is capturing into (-1 when
    it is not capturing); with ``typed`` only its kernel, copy and memset
    nodes, one API call per node."""
    n = ctypes.c_int(0)
    check(lib().sr_capture_nodes(stream.cuda_stream, int(typed),
                                 ctypes.byref(n)))
    return n.value


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype, name: str, *, device=None, ndim=None,
            shape=None, align=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``device``, ``ndim`` and ``shape`` where given, and starting at an
    address that is a multiple of ``align`` bytes, for a kernel's vector
    loads)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != torch.device(device):
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if align is not None and t.data_ptr() % align:
        raise ValueError(f"{name} must start at a multiple of {align} bytes")
