"""Row-major rotation and rigid-transform helpers (the component is the LAST
axis), for the single-instance core.

Port of ``tactilesimulation_tpu/sim/spatial.py``: quaternions are wxyz,
rotation matrices world-from-local, rotation vectors follow the free3d-exp
joint. Shape-polymorphic over leading dims; the small-angle branches are
``torch.where`` selections with both sides finite, so every function is
differentiable. The lane-major helpers in ``lanes.py`` keep the component
FIRST and the batch last; the two layouts stay separate modules.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def cross(a, b):
    """Cross product over the last axis (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_mul(a, b):
    """Hamilton product of wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotvec_to_quat(r):
    """Exponential map so(3) -> unit quaternion; series near 0."""
    angle_sq = torch.sum(r * r, dim=-1, keepdim=True)
    angle = torch.sqrt(angle_sq + _EPS)
    half = 0.5 * angle
    small = angle_sq < 1e-8
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * r], dim=-1)


def quat_to_rotvec(q):
    """Log map, the inverse of ``rotvec_to_quat`` (principal branch)."""
    q = torch.where(q[..., :1] < 0, -q, q)            # the w >= 0 branch
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(s, w)
    small = s < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                        angle / torch.clamp(s, min=_EPS))
    return scale * v


def euler_xyz_to_quat(e):
    """Intrinsic XYZ euler angles -> quaternion (free3d-euler joints)."""
    half = 0.5 * e
    cx, cy, cz = (torch.cos(half[..., 0]), torch.cos(half[..., 1]),
                  torch.cos(half[..., 2]))
    sx, sy, sz = (torch.sin(half[..., 0]), torch.sin(half[..., 1]),
                  torch.sin(half[..., 2]))
    return torch.stack([cx * cy * cz - sx * sy * sz,
                        sx * cy * cz + cx * sy * sz,
                        cx * sy * cz - sx * cy * sz,
                        cx * cy * sz + sx * sy * cz], dim=-1)


def axis_angle_quat(axis, angle):
    """Unit axis (..., 3) + angle (...) -> quaternion (..., 4)."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def mat_vec(R, v):
    """R v over the last axes: R (..., 3, 3), v (..., 3) -> (..., 3)."""
    return torch.sum(R * v[..., None, :], dim=-1)


def mat_tvec(R, v):
    """R^T v over the last axes (world -> local for world-from-local R)."""
    return torch.sum(R * v[..., :, None], dim=-2)


def transform_compose(p_a, q_a, p_b, q_b):
    """Compose rigid transforms: (p, q)_a o (p, q)_b."""
    return p_a + quat_rotate(q_a, p_b), quat_mul(q_a, q_b)


def transform_apply(p, q, x):
    return p + quat_rotate(q, x)


def rotvec_mul(r_a, r_b):
    """Compose two rotation vectors."""
    return quat_to_rotvec(quat_mul(rotvec_to_quat(r_a), rotvec_to_quat(r_b)))
