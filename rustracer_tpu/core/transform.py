"""Transforms: host-side 4x4 matrix+inverse pairs and batched device apply.

Reference: rustracer-core/src/transform.rs. The host-side `Transform` class is
used during scene build (numpy); the batched apply functions run on device
over (..., 3) arrays using (4, 4) or (..., 4, 4) matrices.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class Transform:
    """Matrix + inverse pair (reference transform.rs:10). Host side, numpy."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float32)
        m = np.asarray(m, dtype=np.float32).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        else:
            m_inv = np.asarray(m_inv, dtype=np.float32).reshape(4, 4)
        self.m = m
        self.m_inv = m_inv

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def is_identity(self) -> bool:
        return np.array_equal(self.m, np.eye(4, dtype=np.float32))

    def swaps_handedness(self) -> bool:
        """det of upper-left 3x3 < 0 (reference transform.rs:255)."""
        return bool(np.linalg.det(self.m[:3, :3].astype(np.float64)) < 0.0)

    # --- constructors (reference transform.rs translate/rotate/scale/...) ---
    @staticmethod
    def translate(x, y, z) -> "Transform":
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [x, y, z]
        mi = np.eye(4, dtype=np.float32)
        mi[:3, 3] = [-x, -y, -z]
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z) -> "Transform":
        m = np.diag(np.array([x, y, z, 1.0], dtype=np.float32))
        mi = np.diag(np.array([1.0 / x, 1.0 / y, 1.0 / z, 1.0], dtype=np.float32))
        return Transform(m, mi)

    @staticmethod
    def rotate_x(deg) -> "Transform":
        return Transform._rot(deg, 0)

    @staticmethod
    def rotate_y(deg) -> "Transform":
        return Transform._rot(deg, 1)

    @staticmethod
    def rotate_z(deg) -> "Transform":
        return Transform._rot(deg, 2)

    @staticmethod
    def _rot(deg, axis) -> "Transform":
        t = np.deg2rad(float(deg))
        s, c = np.sin(t), np.cos(t)
        m = np.eye(4, dtype=np.float32)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return Transform(m, m.T.copy())

    @staticmethod
    def rotate(deg, ax, ay, az) -> "Transform":
        """Rotation about arbitrary axis (reference transform.rs rotate)."""
        a = np.array([ax, ay, az], dtype=np.float64)
        a = a / np.linalg.norm(a)
        t = np.deg2rad(float(deg))
        s, c = np.sin(t), np.cos(t)
        m = np.eye(4, dtype=np.float64)
        m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
        m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
        m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
        m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
        m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
        m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
        m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
        m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
        m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
        m = m.astype(np.float32)
        return Transform(m, m.T.copy())

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """Camera-to-world (reference transform.rs look_at)."""
        eye = np.asarray(eye, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = look - eye
        d = d / np.linalg.norm(d)
        right = np.cross(up / np.linalg.norm(up), d)
        nr = np.linalg.norm(right)
        if nr < 1e-12:
            # up parallel to viewing direction; pick an arbitrary right
            right = np.cross(np.array([0.0, 1.0, 0.0001]), d)
            nr = np.linalg.norm(right)
        right /= nr
        new_up = np.cross(d, right)
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, 0] = right
        c2w[:3, 1] = new_up
        c2w[:3, 2] = d
        c2w[:3, 3] = eye
        return Transform(c2w.astype(np.float32))

    @staticmethod
    def perspective(fov_deg, near, far) -> "Transform":
        """Perspective projection (reference transform.rs perspective)."""
        persp = np.array(
            [[1, 0, 0, 0],
             [0, 1, 0, 0],
             [0, 0, far / (far - near), -far * near / (far - near)],
             [0, 0, 1, 0]], dtype=np.float32)
        inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)

    @staticmethod
    def orthographic(near, far) -> "Transform":
        return Transform.scale(1.0, 1.0, 1.0 / (far - near)) * \
            Transform.translate(0.0, 0.0, -near)

    # --- host-side apply (numpy) ---
    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float32)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return r / w[..., None] if not np.allclose(w, 1.0) else r

    def apply_vector(self, v):
        v = np.asarray(v, dtype=np.float32)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n):
        n = np.asarray(n, dtype=np.float32)
        return n @ self.m_inv[:3, :3]


# --- device-side batched apply (jnp; matrices (..., 4, 4) or (4, 4)) ---
#
# NOTE: deliberately scalar-unrolled (no einsum/dot_general). Tiny-matrix
# dot_generals fused between elementwise stages crashed or stalled the
# fusion pass of the previous accelerator's XLA backend; the unrolled
# mul/add form fuses cleanly and is exactly the same FLOPs. Whether the
# plain form compiles as well on the GPU is ROADMAP queue 3 item 3.

def apply_mat3(m, x, y, z):
    """Rows of m[..., :3, :3] applied to (x, y, z) components."""
    rx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z
    ry = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z
    rz = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z
    return rx, ry, rz


def xform_point(m, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx, ry, rz = apply_mat3(m, x, y, z)
    rx = rx + m[..., 0, 3]
    ry = ry + m[..., 1, 3]
    rz = rz + m[..., 2, 3]
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    inv_w = 1.0 / w
    return jnp.stack([rx * inv_w, ry * inv_w, rz * inv_w], axis=-1)


def xform_vector(m, v):
    rx, ry, rz = apply_mat3(m, v[..., 0], v[..., 1], v[..., 2])
    return jnp.stack([rx, ry, rz], axis=-1)


def xform_normal(m_inv, n):
    """Normals transform by the inverse transpose."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    rx = m_inv[..., 0, 0] * x + m_inv[..., 1, 0] * y + m_inv[..., 2, 0] * z
    ry = m_inv[..., 0, 1] * x + m_inv[..., 1, 1] * y + m_inv[..., 2, 1] * z
    rz = m_inv[..., 0, 2] * x + m_inv[..., 1, 2] * y + m_inv[..., 2, 2] * z
    return jnp.stack([rx, ry, rz], axis=-1)


def xform_point_with_error(m, p):
    """Transform a point and return conservative absolute error bounds.

    Reference: transform.rs:190 (transform_point_with_error) — gamma(3) times
    the absolute row sums.
    """
    from .math import gamma
    r = xform_point(m, p)
    am = jnp.abs(m)
    ax, ay, az = jnp.abs(p[..., 0]), jnp.abs(p[..., 1]), jnp.abs(p[..., 2])
    ex, ey, ez = apply_mat3(am, ax, ay, az)
    abs_term = jnp.stack([ex + am[..., 0, 3], ey + am[..., 1, 3],
                          ez + am[..., 2, 3]], axis=-1)
    return r, gamma(3) * abs_term
