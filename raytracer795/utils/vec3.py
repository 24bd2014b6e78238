"""Lane-major 3-vector math: the layout of the hot path.

A ``Vec3`` is a pytree of three ``[N]`` component arrays instead of one
``[N, 3]`` array: every elementwise op then runs over contiguous, unpadded
lanes, and a kernel reads one component of consecutive lanes with one
coalesced load.

All arithmetic is defined componentwise with the SAME operation order as the
``[N, 3]`` formulation (x before y before z in every reduction), so images
produced by the two layouts are bit-identical.

Reference behavior contracts preserved here: orthonormal-basis construction
(src/Helper.cpp:320-343), NaN scrub (src/Scene.cpp:221-228), mirror
reflection (src/Scene.cpp:32-55).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    """Three same-shaped component arrays; a JAX pytree by construction."""

    x: Any
    y: Any
    z: Any

    # -- layout conversions --------------------------------------------------
    @staticmethod
    def from_array(a):
        """Split an [..., 3] array into components (one-time relayout)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(shape, value, dtype=jnp.float32):
        v = jnp.full(shape, value, dtype)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        return Vec3.full(shape, 0.0, dtype)

    @staticmethod
    def ones(shape, dtype=jnp.float32):
        return Vec3.full(shape, 1.0, dtype)

    @staticmethod
    def splat(a):
        """A length-3 constant (numpy/jnp) as scalar components."""
        return Vec3(a[0], a[1], a[2])

    def to_array(self):
        """Back to [..., 3] (do this once, at the film boundary)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self):
        return self.x.dtype

    # -- arithmetic (Vec3 op Vec3 is elementwise; scalars broadcast) ---------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def vdot(a: Vec3, b: Vec3):
    """a . b, reduced x+y+z (same order as sum over a trailing axis)."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def vnorm2(v: Vec3):
    return v.x * v.x + v.y * v.y + v.z * v.z


def vnorm(v: Vec3):
    return jnp.sqrt(vnorm2(v))


def vnormalize(v: Vec3) -> Vec3:
    """v / |v| (no epsilon: mirrors the reference's raw divisions)."""
    return v * (1.0 / vnorm(v))


def vsafe_normalize(v: Vec3, eps: float = 1e-20) -> Vec3:
    return v * (1.0 / jnp.maximum(vnorm(v), eps))


def vmasked_normalize(mask, v: Vec3) -> Vec3:
    """normalize(v) where ``mask``; the unit x vector elsewhere.

    Gradient hygiene (see utils/vecmath.masked_normalize): dead lanes may
    carry zero/inf vectors whose normalize() VJP is NaN even under a later
    ``where``; substituting a unit vector keeps live-lane forward bits
    identical and the backward finite everywhere.
    """
    vx = jnp.where(mask, v.x, 1.0)
    vy = jnp.where(mask, v.y, 0.0)
    vz = jnp.where(mask, v.z, 0.0)
    s = Vec3(vx, vy, vz)
    return s * (1.0 / vnorm(s))


def vwhere(mask, a, b):
    """Componentwise where with a [N] (unexpanded) mask. a/b may be scalar."""
    if not isinstance(a, Vec3):
        a = Vec3(a, a, a)
    if not isinstance(b, Vec3):
        b = Vec3(b, b, b)
    return Vec3(jnp.where(mask, a.x, b.x),
                jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def vany_nan(v: Vec3):
    return jnp.isnan(v.x) | jnp.isnan(v.y) | jnp.isnan(v.z)


def vscrub_nan(v: Vec3) -> Vec3:
    """Zero out vectors containing NaN (src/Scene.cpp:221-228 NanCheck)."""
    bad = vany_nan(v)
    return vwhere(bad, Vec3.zeros(v.shape, v.dtype), v)


def vreflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction (Scene::MirrorReflectance, src/Scene.cpp:35-38)."""
    wo = -d
    wr = -wo + n * (2.0 * vdot(n, wo))
    return vnormalize(wr)


def vorthonormal_u(v: Vec3) -> Vec3:
    """Orthonormal vector via the smallest-|component| trick.

    Mirrors GeometryHelpers::GetOrthonormalUVector (src/Helper.cpp:337-343)
    including argmin's first-wins tie-breaking: set the absolute-smallest
    component to 1, return normalize(v x v').
    """
    ax, ay, az = jnp.abs(v.x), jnp.abs(v.y), jnp.abs(v.z)
    pick0 = (ax <= ay) & (ax <= az)
    pick1 = ~pick0 & (ay <= az)
    pick2 = ~pick0 & ~pick1
    nl = Vec3(jnp.where(pick0, 1.0, v.x),
              jnp.where(pick1, 1.0, v.y),
              jnp.where(pick2, 1.0, v.z))
    return vnormalize(vcross(v, nl))


class Mat3(NamedTuple):
    """Per-lane 3x3 matrix as three Vec3 rows (lane-major)."""

    r0: Vec3
    r1: Vec3
    r2: Vec3

    @staticmethod
    def identity_like(n_shape, dtype=jnp.float32):
        one = jnp.ones(n_shape, dtype)
        zero = jnp.zeros(n_shape, dtype)
        return Mat3(Vec3(one, zero, zero), Vec3(zero, one, zero),
                    Vec3(zero, zero, one))

    def apply(self, v: Vec3) -> Vec3:
        """Row-major matrix-vector product (matches m @ v / sum(m*v))."""
        return Vec3(vdot(self.r0, v), vdot(self.r1, v), vdot(self.r2, v))


def mwhere(mask, a: Mat3, b: Mat3) -> Mat3:
    return Mat3(vwhere(mask, a.r0, b.r0), vwhere(mask, a.r1, b.r1),
                vwhere(mask, a.r2, b.r2))


def const_mat3_apply(m, v: Vec3) -> Vec3:
    """Apply a single (host/static or [3,3] traced) matrix to lane vectors.

    Scalar-expanded so no [N, 3] temporary is ever built; same contraction
    order as utils/vecmath.mat3_apply (j = 0, 1, 2), so bits match.
    """
    return Vec3(m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
                m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
                m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z)


def const_affine_apply(m4, p: Vec3) -> Vec3:
    """Affine 4x4 (rotation+translation rows) applied to lane points."""
    r = const_mat3_apply(m4, p)
    return Vec3(r.x + m4[0, 3], r.y + m4[1, 3], r.z + m4[2, 3])
