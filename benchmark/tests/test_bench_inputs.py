"""The frozen generators give the program's arrays at seed 0."""

import numpy as np
import torch

from conftest import small_cell
from benchlib import inputs, scene as sc
from benchlib import program


def test_scene_equals_program():
    shapes = program.module("models.shapes")
    for n in (3000, 100_000):
        a = sc.many_objects_scene(n, seed=0)
        m = shapes.many_objects_scene(n, seed=0, device="cpu")
        for f in ("positions", "indices", "colors", "normals", "uvs"):
            x, y = getattr(a, f), getattr(m, f).numpy()
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.triangles == 99_936


def test_texture_and_light_equal_program():
    sr = program.package()
    assert np.array_equal(sc.checkerboard(256, 16),
                          sr.checkerboard(256, 16, device="cpu").data.numpy())
    light = sr.Light.default("cpu")
    for k, v in sc.LIGHT.items():
        assert np.array_equal(np.float32(v), getattr(light, k).numpy()), k


def test_cameras_equal_program():
    scenes = program.module("models.scenes")
    tf = program.module("ops.transforms")
    orbit = small_cell("config4_orbit.batch64").config
    base = scenes.config4_many_objects(0.0, triangles=100,
                                       device="cpu").transform
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0]))
    for i in (0, 120, 600):
        want = base @ tf.rotation_matrix(tf.quat_from_axis_angle(
            axis, torch.tensor(i / 60.0)))
        got = inputs.transforms(orbit, np.asarray([i]))[0]
        assert np.abs(got - want.numpy()).max() < 1e-6
    inside = small_cell("config4_inside.view").config
    for t in (0.0, 2.5, 13.0):
        want = scenes.config4_camera(t, inside["width"], inside["height"],
                                     triangles=100, device="cpu").transform
        got = inputs.transforms(inside, np.asarray([0]), start=t)[0]
        assert np.abs(got - want.numpy()).max() < 1e-6
