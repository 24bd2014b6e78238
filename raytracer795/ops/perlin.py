"""Perlin noise with the reference's exact tables and weight function.

Behavior contract (src/Perlin.cpp):
- 16-entry gradient table and the hardcoded shuffle permutation
  {12,7,15,6,11,0,4,9,13,3,14,8,2,5,1,10} (src/Perlin.cpp:4-25);
- weight(x) = -6|x|^5 + 15|x|^4 - 10|x|^3 + 1 — note this is 1 - fade(|x|),
  NOT the classic fade; preserved deliberately (src/Perlin.cpp:27-30);
- lattice hash: shuffled[(x + shuffled[(y + shuffled[z mod 16]) mod 16]) mod 16]
  with non-negative mod (src/Perlin.cpp:86-97);
- noise conversions: linear -> (v+1)/2, absval -> |v| (src/Perlin.cpp:76-81);
- bump gradient via forward differences with eps=0.001 (src/Perlin.cpp:36-50).

Points are lane-major ``Vec3`` (three [N] arrays, utils/vec3.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracer795.scene import types as T
from raytracer795.utils.vec3 import Vec3

_TABLE = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    [1, 1, 0], [-1, 1, 0], [0, -1, 1], [0, -1, -1],
], np.float32)

_SHUFFLED = np.array([12, 7, 15, 6, 11, 0, 4, 9, 13, 3, 14, 8, 2, 5, 1, 10],
                     np.int32)

_EPS = 0.001


def _weight(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.abs(x)
    return ((-6.0) * x**5) + (15.0 * x**4) - (10.0 * x**3) + 1.0


def _hash(lx, ly, lz) -> jnp.ndarray:
    """Lattice int components -> gradient index (src/Perlin.cpp:86-97)."""
    shuffled = jnp.asarray(_SHUFFLED)
    h = shuffled[jnp.mod(lz, 16)]
    h = shuffled[jnp.mod(ly + h, 16)]
    return shuffled[jnp.mod(lx + h, 16)]


def perlin(p: Vec3, scale, nc: int) -> jnp.ndarray:
    """Noise value for lane points p (src/Perlin.cpp:52-84)."""
    tx = jnp.asarray(_TABLE[:, 0])
    ty = jnp.asarray(_TABLE[:, 1])
    tz = jnp.asarray(_TABLE[:, 2])
    px, py, pz = p.x * scale, p.y * scale, p.z * scale
    bx = jnp.floor(px).astype(jnp.int32)
    by = jnp.floor(py).astype(jnp.int32)
    bz = jnp.floor(pz).astype(jnp.int32)
    value = jnp.zeros(px.shape, px.dtype)
    for i in range(2):
        for j in range(2):
            for k in range(2):
                lx, ly, lz = bx + i, by + j, bz + k
                gi = _hash(lx, ly, lz)
                gx, gy, gz = tx[gi], ty[gi], tz[gi]
                rx = px - lx.astype(px.dtype)
                ry = py - ly.astype(px.dtype)
                rz = pz - lz.astype(px.dtype)
                w = _weight(rx) * _weight(ry) * _weight(rz)
                value = value + (gx * rx + gy * ry + gz * rz) * w
    if nc == T.NC_LINEAR:
        value = (value + 1.0) * 0.5
    elif nc == T.NC_ABSVAL:
        value = jnp.abs(value)
    return value


def perlin_gradient(p: Vec3, scale, nc: int) -> Vec3:
    """Forward-difference gradient, eps=0.001 (src/Perlin.cpp:36-50).

    Kept finite-difference (not autodiff) for bit-level parity with the
    reference's bump mapping.
    """
    v0 = perlin(p, scale, nc)
    gx = (perlin(Vec3(p.x + _EPS, p.y, p.z), scale, nc) - v0) / _EPS
    gy = (perlin(Vec3(p.x, p.y + _EPS, p.z), scale, nc) - v0) / _EPS
    gz = (perlin(Vec3(p.x, p.y, p.z + _EPS), scale, nc) - v0) / _EPS
    return Vec3(gx, gy, gz)
