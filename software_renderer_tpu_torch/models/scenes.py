"""Demo scenes and the graded benchmark configs, as ``(time) ->
RenderPass`` functions on a chosen device (the card unless the caller
passes ``device="cpu"``; see device.py).

Config 3 reads the Utah teapot from the checked-in assets/teapot.obj,
and regenerates it from the Newell patches (models/teapot.py) when the
file is missing, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..device import or_default
from ..ops import transforms as tf
from ..ops.shading import Light
from ..ops.texture import checkerboard
from ..render import RenderPass
from . import shapes
from .mesh import Mesh, mesh_from_numpy
from .obj import load_obj
from .teapot import teapot_mesh

TEAPOT_OBJ = Path(__file__).resolve().parents[2] / "assets" / "teapot.obj"


def _axis(v, device):
    return tf.normalize(torch.tensor(v, dtype=torch.float32, device=device))


def reference_sphere(time, width: int = 512, height: int = 512,
                     backend_shading: str = "vertex",
                     device=None) -> RenderPass:
    """The reference's live demo: 13x13 UV sphere, inward normals,
    abs(normal) colors, the reference demo transform."""
    device = or_default(device)
    mesh = shapes.uv_sphere(radius=0.2, segments=13, inward_normals=True,
                            device=device)
    return RenderPass(mesh=mesh,
                      transform=tf.reference_demo_transform(time, device),
                      width=width, height=height, shading=backend_shading,
                      flat_color=torch.ones(3, device=device))


def rotating_triangle(time, width: int = 512, height: int = 512,
                      device=None) -> RenderPass:
    """The reference's rotating-triangle demo: one vertex-colored triangle
    spinning about the view axis, in NDC."""
    device = or_default(device)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    mesh = Mesh(positions=f([[0.0, 0.5, 0.5], [-0.5, 0.0, 0.5],
                             [0.5, -0.5, 0.5]]),
                indices=torch.tensor([0, 1, 2], dtype=torch.int32,
                                     device=device),
                colors=f([[1, 0, 0], [0, 1, 0], [0, 0, 1]]))
    q = tf.quat_from_axis_angle(f([0.0, 0.0, 1.0]),
                                torch.as_tensor(time, dtype=torch.float32,
                                                device=device))
    return RenderPass(mesh=mesh, transform=tf.rotation_matrix(q),
                      width=width, height=height, shading="vertex",
                      flat_color=torch.ones(3, device=device))


_CUBE_EDGES = np.array([
    [0, 1], [1, 3], [3, 2], [2, 0],   # back face
    [4, 5], [5, 7], [7, 6], [6, 4],   # front face
    [0, 4], [1, 5], [2, 6], [3, 7],   # connectors
], np.int32)


def wireframe_cube(time, width: int = 512, height: int = 512,
                   device=None) -> RenderPass:
    """The reference's cube demo: a spinning green wireframe cube of 12
    line segments (``primitive="line"``), two composed rotations."""
    device = or_default(device)
    corners = np.array(
        [[x, y, z] for z in (-0.5, 0.5) for y in (-0.5, 0.5)
         for x in (-0.5, 0.5)], np.float32)
    mesh = mesh_from_numpy(corners, _CUBE_EDGES.reshape(-1),
                           colors=np.tile(np.array([[0.0, 1.0, 0.0]]),
                                          (8, 1)), device=device)
    t = torch.as_tensor(time, dtype=torch.float32, device=device)
    qy = tf.quat_from_axis_angle(
        torch.tensor([0.0, 1.0, 0.0], device=device), t * 0.5)
    qx = tf.quat_from_axis_angle(
        torch.tensor([1.0, 0.0, 0.0], device=device), t * 0.1 + 1.2)
    model = tf.trs_matrix(translation=(0.0, 0.0, 1.0),
                          rotation=tf.quat_mul(qy, qx),
                          scale=(1.2, 1.2, 1.2))
    return RenderPass(mesh=mesh,
                      transform=tf.reference_projection(device) @ model,
                      width=width, height=height, primitive="line",
                      flat_color=torch.ones(3, device=device))


def intersecting_triangles(time, width: int = 512, height: int = 512,
                           device=None) -> RenderPass:
    """The reference's triangles demo: two interpenetrating triangles for
    the depth test, one rotating about y."""
    device = or_default(device)
    positions = np.array([
        [0.0, 0.6, 0.5], [0.6, -0.6, 0.5], [-0.6, -0.6, 0.5],
        [0.0, 0.6, 0.5], [0.0, -0.6, 0.25], [0.0, -0.6, 0.75],
    ], np.float32)
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]] * 2, np.float32)
    mesh = mesh_from_numpy(positions, np.arange(6, dtype=np.int32),
                           colors=colors, device=device)
    q = tf.quat_from_axis_angle(
        torch.tensor([0.0, 1.0, 0.0], device=device),
        torch.as_tensor(time, dtype=torch.float32, device=device) * 0.5)
    model = tf.trs_matrix(translation=(0.0, 0.0, 0.3), rotation=q)
    return RenderPass(mesh=mesh, transform=model, width=width, height=height,
                      shading="vertex",
                      flat_color=torch.ones(3, device=device))


def config1_flat_cube(time, width: int = 256, height: int = 256,
                      device=None) -> RenderPass:
    """Config 1: a single rotating face-colored cube at 256^2."""
    device = or_default(device)
    mesh = shapes.box(size=0.8, face_colors=True, device=device)
    q = tf.quat_from_axis_angle(_axis([1.0, 1.0, 0.0], device),
                                torch.as_tensor(time, dtype=torch.float32,
                                                device=device))
    model = tf.trs_matrix(translation=(0.0, 0.0, 1.0), rotation=q)
    return RenderPass(mesh=mesh,
                      transform=tf.reference_projection(device) @ model,
                      width=width, height=height, shading="vertex",
                      flat_color=torch.ones(3, device=device))


def config2_textured_cube(time, width: int = 512, height: int = 512,
                          device=None) -> RenderPass:
    """Config 2: textured Phong cube, z-buffer + backface culling."""
    device = or_default(device)
    mesh = shapes.box(size=0.8, face_colors=False, device=device)
    q = tf.quat_from_axis_angle(_axis([1.0, 2.0, 0.5], device),
                                torch.as_tensor(time, dtype=torch.float32,
                                                device=device))
    model = tf.trs_matrix(translation=(0.0, 0.0, 1.0), rotation=q)
    return RenderPass(mesh=mesh,
                      transform=tf.reference_projection(device) @ model,
                      width=width, height=height, shading="textured",
                      texture=checkerboard(128, 8, device=device),
                      cull_backfaces=True, light=Light.default(device),
                      model=model, flat_color=torch.ones(3, device=device))


def _teapot_mesh(device=None) -> Mesh:
    """Config 3's teapot on ``device``: assets/teapot.obj through the OBJ
    reader, or, when the file is missing, ``teapot_mesh(9)`` (5,112
    triangles) with abs(normal) colors, as the JAX package builds it."""
    device = or_default(device)
    if TEAPOT_OBJ.exists():
        return load_obj(str(TEAPOT_OBJ), device=device)
    p, t, n, uv = teapot_mesh(9)
    return mesh_from_numpy(p, t.reshape(-1), colors=np.abs(n), normals=n,
                           uvs=uv, device=device)


def config3_phong_mesh(time, width: int = 1024, height: int = 1024,
                       device=None) -> RenderPass:
    """Config 3: the Utah teapot (~5k triangles), per-pixel Phong at
    1024^2."""
    device = or_default(device)
    mesh = _teapot_mesh(device)
    q = tf.quat_from_axis_angle(_axis([1.0, 0.7, 0.2], device),
                                torch.as_tensor(time, dtype=torch.float32,
                                                device=device))
    model = tf.trs_matrix(translation=(0.0, 0.0, 1.0), rotation=q,
                          scale=(1.5, 1.5, 1.5))
    return RenderPass(mesh=mesh,
                      transform=tf.reference_projection(device) @ model,
                      width=width, height=height, shading="phong",
                      light=Light.default(device), model=model,
                      flat_color=torch.ones(3, device=device))


def config4_many_objects(time, width: int = 1920, height: int = 1080,
                         triangles: int = 100_000, textured: bool = True,
                         device=None) -> RenderPass:
    """Config 4: the ~100k-triangle multi-object scene, Phong + bilinear
    texture at 1920x1080 (the north-star scene)."""
    device = or_default(device)
    mesh = shapes.many_objects_scene(target_triangles=triangles,
                                     device=device)
    q = tf.quat_from_axis_angle(
        torch.tensor([0.0, 1.0, 0.0], device=device),
        torch.as_tensor(time, dtype=torch.float32, device=device) * 0.3)
    model = tf.trs_matrix(translation=(0.0, 0.0, 0.4), rotation=q)
    return RenderPass(
        mesh=mesh, transform=tf.reference_projection(device) @ model,
        width=width, height=height,
        shading="textured" if textured else "phong",
        texture=checkerboard(256, 16, device=device) if textured else None,
        light=Light.default(device), model=model, cull_backfaces=True,
        flat_color=torch.ones(3, device=device))


def config4_camera(time, width: int = 1920, height: int = 1080,
                   triangles: int = 100_000, textured: bool = True,
                   device=None) -> RenderPass:
    """Config 4 under a perspective camera inside the object cloud:
    ``perspective(pi/3, width/height, 0.05, 10) @ look_at((0, 0, 0.6),
    (0, 0, 1.6)) @ model``, with the near-plane clip and
    perspective-correct attributes on. At full size about 1,100-1,400
    triangles straddle the eye plane."""
    rp = config4_many_objects(time, width, height, triangles, textured,
                              device=device)
    dev = rp.transform.device
    view = (tf.perspective(torch.pi / 3, width / height, 0.05, 10.0,
                           device=dev)
            @ tf.look_at((0.0, 0.0, 0.6), (0.0, 0.0, 1.6), device=dev))
    return dataclasses.replace(rp, transform=view @ rp.model,
                               clip_near=True, perspective_correct=True)
