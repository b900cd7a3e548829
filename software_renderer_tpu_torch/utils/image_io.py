"""Image IO: dependency-free PNG and PPM writers and a PNG reader.

Counterpart of the JAX package's utils/image_io.py, with the same bytes
for the same image: PNG encoding uses only the stdlib ``zlib`` and
``struct``; the C++ encoder in runtime/ is the bulk path. Every function
takes a numpy array or a tensor; a tensor (on any device) is copied to
the host once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def host_array(image) -> np.ndarray:
    """``image`` as a numpy array: a tensor is copied to the host once
    (no copy for a CPU tensor)."""
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(image, level: int = 6) -> bytes:
    """Encode an RGB(A) uint8 image [H, W, 3|4] (or grayscale [H, W]) to
    in-memory PNG bytes (the live present surface streams these)."""
    img = host_array(image)
    if img.dtype != np.uint8:
        raise ValueError("encode_png expects uint8 (use to_rgba8 first)")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    payload = zlib.compress(raw, level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", payload) + _png_chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    """Write an RGB(A) uint8 image [H, W, 3|4] (or grayscale [H, W])."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(ftype: int, row: np.ndarray, prev: np.ndarray,
              channels: int) -> np.ndarray:
    """One PNG scanline's filter undone (int32 rows, values 0-255)."""
    if ftype == 0:
        return row
    if ftype == 2:  # up
        return (row + prev) & 0xFF
    if ftype not in (1, 3, 4):
        raise ValueError(f"unsupported filter {ftype}")
    cur = np.zeros_like(row)
    for i in range(row.shape[0]):
        a = cur[i - channels] if i >= channels else 0
        b = prev[i]
        if ftype == 1:
            cur[i] = (row[i] + a) & 0xFF
        elif ftype == 3:
            cur[i] = (row[i] + (a + b) // 2) & 0xFF
        else:
            c = prev[i - channels] if i >= channels else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (row[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] (8-bit, no interlace, filters 0-4):
    the writers' output, and the present surface's ``/frame.png``."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG stream")
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitd, ctype = struct.unpack(">IIBB", payload[:10])
            if bitd != 8:
                raise ValueError(f"unsupported bit depth {bitd}")
            channels = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                            np.uint8).astype(np.int32)
        prev = _unfilter(raw[pos], row, prev, channels)
        out[y] = prev.astype(np.uint8)
        pos += 1 + stride
    return out.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for the writers' own output (8-bit, no
    interlace, filters 0-4)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_ppm(path: str, image) -> None:
    """Binary PPM (RGB only — alpha dropped)."""
    img = host_array(image)
    if img.dtype != np.uint8:
        raise ValueError("write_ppm expects uint8")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img[..., :3].tobytes())
