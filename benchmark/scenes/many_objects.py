"""Config 4's scene: the program's ``models/shapes.py``
``many_objects_scene`` (a sphere, a box and a torus placed at random
until ``target_triangles``), frozen in benchlib/scene.py. The layout
comes from the seed."""

from benchlib import scene as sc

KEYS = {"generator", "target_triangles", "extent"}


def make(params: dict, seed: int) -> sc.SceneArrays:
    return sc.many_objects_scene(params["target_triangles"], seed=seed,
                                 extent=params["extent"])
