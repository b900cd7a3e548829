"""Render configuration, with a JSON round trip.

Counterpart of the JAX package's utils/config.py: the knobs the
reference hardcodes (framebuffer size, backend, shading, supersampling,
culling, projection, animation step, scene, batch) in one object.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RenderConfig:
    width: int = 512
    height: int = 512
    # 'auto' | 'pallas' | 'binned' | 'reference'
    backend: str = "auto"
    # 'vertex' | 'flat' | 'phong' | 'textured'
    shading: str = "vertex"
    # Supersampling factor (ops/msaa.py).
    msaa: int = 1
    cull_backfaces: bool = False
    # 'reference' (w = z + 1) or 'perspective'.
    projection: str = "reference"
    fov_y: float = 1.0471975512  # 60 deg
    z_near: float = 0.1
    z_far: float = 100.0
    time_step: float = 1.0 / 60.0
    scene: str = "reference_sphere"
    obj_path: Optional[str] = None
    target_triangles: int = 100_000
    batch: int = 1

    def projection_matrix(self, device=None):
        """The configured projection, on the card unless ``device`` says
        otherwise (device.py)."""
        from ..ops import transforms as tf
        if self.projection == "reference":
            return tf.reference_projection(device)
        return tf.perspective(self.fov_y, self.width / self.height,
                              self.z_near, self.z_far, device=device)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def load(cls, path: str) -> "RenderConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
