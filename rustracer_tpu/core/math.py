"""Vector/point/normal math over (..., 3) arrays.

Batched replacement for the reference's scalar `Vector3f/Point3f/Normal3f`
types (reference: rustracer-core/src/geometry/). Everything here is shape-
polymorphic and batched: a "vector" is any array whose trailing axis has
length 3, so whole ray wavefronts are one array and ops vectorize.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Numeric constants (reference: rustracer-core/src/lib.rs:88-120)
MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps * 0.5)
INFINITY = np.float32(np.inf)
PI = np.float32(np.pi)
INV_PI = np.float32(1.0 / np.pi)
INV_2_PI = np.float32(1.0 / (2.0 * np.pi))
INV_4_PI = np.float32(1.0 / (4.0 * np.pi))
PI_OVER_2 = np.float32(np.pi / 2.0)
PI_OVER_4 = np.float32(np.pi / 4.0)
SQRT_2 = np.float32(np.sqrt(2.0))
ONE_MINUS_EPSILON = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
SHADOW_EPSILON = np.float32(1e-4)


def gamma(n) -> np.float32:
    """Error-bound gamma(n) = n*eps / (1 - n*eps) (reference lib.rs:121-124)."""
    return np.float32((n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON))


def vec(x, y, z, dtype=jnp.float32):
    return jnp.stack([jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                      jnp.asarray(z, dtype)], axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v, eps=1e-20):
    """Safe normalize: zero vectors stay finite (important under grad)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps))


def distance(a, b):
    return length(a - b)


def distance_squared(a, b):
    return length_squared(a - b)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def face_forward(n, v):
    """Flip n to lie in the hemisphere of v (reference geometry/mod.rs)."""
    return jnp.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Build an orthonormal frame from a unit vector (reference lib.rs:187-203).

    Returns (v2, v3) with v1 x v2 = v3 (right-handed).
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    inv_a = jax.lax.rsqrt(jnp.where(use_x, x * x + z * z, y * y + z * z))
    v2 = jnp.where(
        use_x[..., None],
        jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1),
        jnp.stack([jnp.zeros_like(x), z * inv_a, -y * inv_a], axis=-1),
    )
    v3 = cross(v1, v2)
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack([sin_theta * jnp.cos(phi),
                      sin_theta * jnp.sin(phi),
                      cos_theta], axis=-1)


def spherical_direction_in(sin_theta, cos_theta, phi, x, y, z):
    """Spherical direction in the frame (x, y, z)."""
    return (sin_theta * jnp.cos(phi))[..., None] * x + \
           (sin_theta * jnp.sin(phi))[..., None] * y + \
           cos_theta[..., None] * z


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * PI, p)


# --- shading-space trig helpers (reference geometry/mod.rs cos_theta family) ---
# Shading space: z is the shading normal; w is a unit direction in that frame.

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    return jnp.sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.where(st == 0.0, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 0.0, jnp.clip(w[..., 1] / jnp.where(st == 0.0, 1.0, st), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def reflect(wo, n):
    """Mirror wo about n (both pointing away from surface)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta.

    Returns (wt, valid) where valid is False on total internal reflection.
    (reference geometry/mod.rs refract)
    """
    cos_theta_i = dot(n, wi)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - cos_theta_i * cos_theta_i)
    sin2_theta_t = eta * eta * sin2_theta_i
    valid = sin2_theta_t < 1.0
    cos_theta_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_theta_t))
    wt = eta[..., None] * (-wi) + (eta * cos_theta_i - cos_theta_t)[..., None] * n
    return wt, valid


def offset_ray_origin(p, p_error, n, w):
    """Robustly offset a spawned ray origin off the surface.

    Reference: rustracer-core/src/geometry/mod.rs:203 (offset_ray_origin):
    shift along the geometric normal by the projected error bound, then round
    each component away from p so the origin is strictly outside the error box.
    """
    d = jnp.sum(jnp.abs(n) * p_error, axis=-1)
    offset = d[..., None] * n
    offset = jnp.where(dot(w, n)[..., None] < 0.0, -offset, offset)
    po = p + offset
    # round away from p (next_float_up/down per component)
    up = next_float_up(po)
    down = next_float_down(po)
    po = jnp.where(offset > 0.0, up, jnp.where(offset < 0.0, down, po))
    return po


def next_float_up(x):
    """Next representable float32 toward +inf (reference lib.rs next_float_up)."""
    xi = jnp.asarray(x, jnp.float32)
    bits = jax.lax.bitcast_convert_type(xi, jnp.int32)
    is_neg = bits < 0
    # handle -0.0 -> smallest positive subnormal path via +0 rewrite
    xi = jnp.where(xi == 0.0, jnp.float32(0.0), xi)
    bits = jax.lax.bitcast_convert_type(xi, jnp.int32)
    is_neg = bits < 0
    nbits = jnp.where(is_neg, bits - 1, bits + 1)
    out = jax.lax.bitcast_convert_type(nbits, jnp.float32)
    return jnp.where(jnp.isinf(xi) & (xi > 0), xi, out)


def next_float_down(x):
    return -next_float_up(-jnp.asarray(x, jnp.float32))


def erf_inv(x):
    """Inverse error function (reference geometry/mod.rs erf_inv, PBRT impl)."""
    x = jnp.clip(x, -0.99999, 0.99999)
    w = -jnp.log((1.0 - x) * (1.0 + x))
    small = w < 5.0
    w_s = w - 2.5
    w_l = jnp.sqrt(jnp.maximum(w, 5.0)) - 3.0
    p_s = 2.81022636e-08
    p_s = 3.43273939e-07 + p_s * w_s
    p_s = -3.5233877e-06 + p_s * w_s
    p_s = -4.39150654e-06 + p_s * w_s
    p_s = 0.00021858087 + p_s * w_s
    p_s = -0.00125372503 + p_s * w_s
    p_s = -0.00417768164 + p_s * w_s
    p_s = 0.246640727 + p_s * w_s
    p_s = 1.50140941 + p_s * w_s
    p_l = -0.000200214257
    p_l = 0.000100950558 + p_l * w_l
    p_l = 0.00134934322 + p_l * w_l
    p_l = -0.00367342844 + p_l * w_l
    p_l = 0.00573950773 + p_l * w_l
    p_l = -0.0076224613 + p_l * w_l
    p_l = 0.00943887047 + p_l * w_l
    p_l = 1.00167406 + p_l * w_l
    p_l = 2.83297682 + p_l * w_l
    return jnp.where(small, p_s, p_l) * x


def erf(x):
    return jax.lax.erf(x)


def quadratic(a, b, c):
    """Stable quadratic solve; returns (t0, t1, has_solution).

    Replaces the reference's EFloat::solve_quadratic (efloat.rs) — instead of
    interval arithmetic we use the numerically-stable form in f32 and rely on
    conservative ray-origin offsetting (offset_ray_origin) for robustness.
    """
    # compute discriminant in higher-effective precision via the standard trick
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / a
    t1 = c / jnp.where(q == 0.0, 1.0, q)
    t1 = jnp.where(q == 0.0, t0, t1)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return lo, hi, has


def find_interval(cdf, x):
    """Bisection find_interval (reference lib.rs:160-180), vectorized.

    cdf: (..., N) monotonically nondecreasing; x: (...). Returns largest i with
    cdf[i] <= x, clamped to [0, N-2].
    """
    n = cdf.shape[-1]
    idx = jnp.sum((cdf <= x[..., None]).astype(jnp.int32), axis=-1) - 1
    return jnp.clip(idx, 0, n - 2)
