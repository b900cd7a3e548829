"""software_renderer_tpu_torch — the PyTorch + CUDA port of
``software_renderer_tpu``.

Same RenderPass in, same framebuffer out: triangles on every backend,
row bands, supersampling, lines and points, and the pixel formats, mesh
helpers and render config of the JAX package's public surface; around
them the frame loop and live viewer (utils/), the native OBJ/PNG runtime
(runtime/), and chunked and sharded batches (parallel/). On CUDA
tensors the triangle path runs hand-written Hopper kernels (csrc/*.cu,
built with nvcc at first use); on CPU tensors it runs their plain
PyTorch versions. This package imports neither JAX nor the JAX package,
which stays the reference it is checked against.
"""

from .framebuffer import (CLEAR_COLOR, CLEAR_DEPTH, NO_TRIANGLE,
                          PIXEL_FORMATS, Framebuffer, bytes_per_pixel, clear,
                          create_framebuffer, decode_pixels, encode_pixels,
                          to_bgra8, to_rgba8)
from .models import shapes
from .models.mesh import Mesh, merge_meshes, mesh_from_numpy, transform_mesh
from .models.obj import load_obj, save_obj
from .ops import transforms
from .ops.msaa import render_msaa
from .ops.shading import Light
from .ops.texture import Texture, checkerboard
from .render import RenderPass, render, render_rows
from .utils.config import RenderConfig

__all__ = [
    "Framebuffer", "create_framebuffer", "clear", "to_rgba8", "to_bgra8",
    "encode_pixels", "decode_pixels", "bytes_per_pixel", "PIXEL_FORMATS",
    "CLEAR_COLOR", "CLEAR_DEPTH", "NO_TRIANGLE",
    "RenderPass", "render", "render_rows", "render_msaa",
    "Mesh", "mesh_from_numpy", "merge_meshes", "transform_mesh", "shapes",
    "load_obj", "save_obj",
    "transforms", "Light", "Texture", "checkerboard", "RenderConfig",
]
