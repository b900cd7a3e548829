"""Transform math: quaternions, TRS matrices, the reference projection.

Conventions follow the JAX package (ops/transforms.py): column vectors
(``clip = M @ [x, y, z, 1]``), quaternions laid out (x, y, z, w), NDC z
in [0, 1], the reference demo projection ``w = z + 1``, and the camera
(``perspective``, ``look_at``) right-handed, looking down -z. Every
function returns float32 tensors on the device of its tensor arguments;
where no argument is a tensor, on ``device``, which defaults to the card
(device.py: without one it raises rather than build on the CPU).
"""

from __future__ import annotations

import torch

from ..device import or_default


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device or x.device)
    return torch.as_tensor(x, dtype=torch.float32, device=or_default(device))


def _device_of(*args, device=None):
    """``device`` if given, else the device of the first tensor argument,
    else the default device (device.py)."""
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return or_default(None)


def quat_from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` radians about the
    (already normalized) ``axis``."""
    axis = _f32(axis)
    half = _f32(angle, axis.device) / 2.0
    return torch.cat([axis * torch.sin(half), torch.cos(half)[None]])


def quat_mul(q1, q2) -> torch.Tensor:
    """Hamilton product q1 * q2 (q2 applied first)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_to_matrix(q) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def normalize(v, eps: float = 1e-20) -> torch.Tensor:
    v = _f32(v)
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=eps))


def inverse_transpose_3x3(m) -> torch.Tensor:
    """Closed-form adjugate inverse-transpose of a 3x3 (the normal
    matrix); the scale is irrelevant for normals, which are renormalized
    per pixel."""
    m = _f32(m)
    c0 = torch.linalg.cross(m[:, 1], m[:, 2])
    c1 = torch.linalg.cross(m[:, 2], m[:, 0])
    c2 = torch.linalg.cross(m[:, 0], m[:, 1])
    det = torch.dot(m[:, 0], c0)
    adj_t = torch.stack([c0, c1, c2], dim=1)
    return adj_t / torch.where(det == 0.0, 1.0, det)


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=or_default(device))


def translation_matrix(t, device=None) -> torch.Tensor:
    t = _f32(t, device)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def scale_matrix(s, device=None) -> torch.Tensor:
    s = torch.broadcast_to(_f32(s, device), (3,))
    return torch.diag(torch.cat([s, torch.ones(1, device=s.device)]))


def rotation_matrix(q) -> torch.Tensor:
    """Quaternion -> homogeneous 4x4."""
    m = torch.eye(4, dtype=torch.float32, device=q.device)
    m[:3, :3] = quat_to_matrix(q)
    return m


def trs_matrix(translation=(0.0, 0.0, 0.0), rotation=(0.0, 0.0, 0.0, 1.0),
               scale=(1.0, 1.0, 1.0), device=None) -> torch.Tensor:
    """T @ R @ S (RealityKit ``Transform.matrix`` order)."""
    device = _device_of(rotation, translation, scale, device=device)
    return (translation_matrix(translation, device)
            @ rotation_matrix(_f32(rotation, device))
            @ scale_matrix(scale, device))


def reference_projection(device=None) -> torch.Tensor:
    """The reference demo projection: w = z + 1 (eye at (0, 0, -1))."""
    return torch.tensor([[1.0, 0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0],
                         [0.0, 0.0, 1.0, 1.0]], dtype=torch.float32,
                        device=or_default(device))


def perspective(fov_y, aspect, z_near, z_far, device=None) -> torch.Tensor:
    """Perspective projection mapping view z in [-near, -far] (looking
    down -z) to NDC z in [0, 1], with clip w = -z_view."""
    f = 1.0 / torch.tan(_f32(fov_y, device) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32, device=f.device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """Right-handed view matrix: the camera at ``eye`` looks at
    ``target`` down its -z axis."""
    device = _device_of(eye, target, up, device=device)
    eye, target, up = (_f32(v, device) for v in (eye, target, up))
    fwd = normalize(target - eye)
    right = normalize(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd])
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = rot
    # -rot @ eye as multiply-adds: no matrix unit, so no TF32 on a card.
    m[:3, 3] = -(rot[:, 0] * eye[0] + rot[:, 1] * eye[1]
                 + rot[:, 2] * eye[2])
    return m


def project_ndc_to_uv(p, device=None) -> torch.Tensor:
    """The reference's NDC -> uv projection as it was meant: xy scaled by
    1 / (z + 1) (eye at (0, 0, -1)), then shifted by 0.5."""
    p = _f32(p, device)
    scale = 1.0 / (p[..., 2] + 1.0)
    return p[..., :2] * scale[..., None] + 0.5


def project_ndc_to_uv_literal(p, device=None) -> torch.Tensor:
    """The reference's projection as it runs: p.xy (its early return)."""
    return _f32(p, device)[..., :2]


def reference_demo_transform(time, device=None) -> torch.Tensor:
    """The reference live scene's per-frame MVP: two composed quaternion
    rotations, translate z=+1, uniform scale 2, then w = z + 1."""
    time = _f32(time, device)
    q1 = quat_from_axis_angle(
        normalize(torch.tensor([1.0, 1.0, 0.0], device=time.device)), time)
    q2 = quat_from_axis_angle(
        torch.tensor([0.0, 0.0, 1.0], device=time.device), time * 0.5)
    model = trs_matrix(translation=(0.0, 0.0, 1.0), rotation=quat_mul(q1, q2),
                       scale=(2.0, 2.0, 2.0))
    return reference_projection(time.device) @ model
