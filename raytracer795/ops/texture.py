"""Texture sampling and decal application (lane-major Vec3 layout).

Sampling contract (src/Texture.cpp:41-131): wrap uv by u-floor(u), scale by
width/height, clamp pixel fetches to the image, nearest = int truncation,
bilinear = 4-tap with fractional weights. Images store raw source values
(bytes 0..255 for LDR, radiance floats for EXR).

Decal application (src/Shape.cpp:400-616): per hit, the object's (up to two)
textures apply in order; replace_kd/blend_kd/replace_all set the hit's
diffuse-replacement color + normalizer, replace_normal/bump_normal rewrite
the shading normal via TBN / derivative math, perlin variants use the noise
field at the local hit point.

Pixel fetches gather per color plane (three [N] gathers from flattened
[H*W] planes) so no [N, 3] temporaries are built.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from raytracer795.ops import perlin as perlin_ops
from raytracer795.ops.intersect import HitDetails
from raytracer795.scene import types as T
from raytracer795.utils.vec3 import (Vec3, vcross, vdot,
                                     vmasked_normalize, vnormalize,
                                     vwhere)


class TexturedHit(NamedTuple):
    dm: jnp.ndarray             # [N] int32 decal mode for diffuse (DECAL_*)
    tex_color: Vec3
    tex_normalizer: jnp.ndarray  # [N]
    normal: Vec3                # possibly rewritten by normal maps


def _planes(tex: T.Texture):
    img = tex.image
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, 3)
    return (flat[:, 0], flat[:, 1], flat[:, 2]), h, w


def sample_image(tex: T.Texture, u: jnp.ndarray, v: jnp.ndarray) -> Vec3:
    """GetColorAtCoordinates (src/Texture.cpp:111-131). [N] uv -> Vec3."""
    (pr, pg, pb), h, w = _planes(tex)
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    i = u * w
    j = v * h

    def fetch(ii, jj):
        ii = jnp.clip(ii, 0, w - 1)
        jj = jnp.clip(jj, 0, h - 1)
        idx = jj * w + ii
        return Vec3(pr[idx], pg[idx], pb[idx])

    if tex.interp == T.INTERP_NN:
        return fetch(i.astype(jnp.int32), j.astype(jnp.int32))
    i0 = jnp.floor(i).astype(jnp.int32)
    j0 = jnp.floor(j).astype(jnp.int32)
    a = i - i0
    b = j - j0
    return (fetch(i0, j0) * ((1 - a) * (1 - b))
            + fetch(i0, j0 + 1) * ((1 - a) * b)
            + fetch(i0 + 1, j0) * (a * (1 - b))
            + fetch(i0 + 1, j0 + 1) * (a * b))


def sample_gradient(tex: T.Texture, u: jnp.ndarray, v: jnp.ndarray):
    """GetChangeAtCoordinates (src/Texture.cpp:76-109): (du, dv) [N] each."""
    (pr, pg, pb), h, w = _planes(tex)
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    i = jnp.clip((u * w).astype(jnp.int32), 0, w - 2)
    j = jnp.clip((v * h).astype(jnp.int32), 0, h - 2)

    def fetch(ii, jj):
        ii = jnp.clip(ii, 0, w - 1)
        jj = jnp.clip(jj, 0, h - 1)
        idx = jj * w + ii
        return Vec3(pr[idx], pg[idx], pb[idx])

    def mean3(c: Vec3):
        return (c.x + c.y + c.z) / 3.0

    c00 = fetch(i, j)
    du = mean3(fetch(i + 1, j)) - mean3(c00)
    dv = mean3(fetch(i, j + 1) - c00)
    return du, dv


def _sphere_dp(det: HitDetails):
    """Sphere dpdu/dpdv at the hit (src/Shape.cpp:430-433)."""
    lc = det.local_point - det.local_center
    pi = jnp.pi
    sel = det.valid & det.is_sphere
    cos_t = jnp.clip(lc.y / jnp.where(det.radius > 0, det.radius, 1.0),
                     -1.0, 1.0)
    # double-where: dead lanes clip to +/-1 where arccos' grad is infinite
    theta = jnp.arccos(jnp.where(sel, cos_t, 0.0))
    phi = jnp.arctan2(lc.z, jnp.where(sel, lc.x, 1.0))
    dpdu = Vec3(lc.z * 2 * pi, jnp.zeros_like(phi), lc.x * (-2) * pi)
    dpdv = Vec3(lc.y * jnp.cos(phi) * pi,
                (-1.0) * det.radius * jnp.sin(theta) * pi,
                lc.y * jnp.sin(phi) * pi)
    return dpdu, dpdv


def _tri_tb(det: HitDetails):
    """Triangle tangent/bitangent from the edge/UV system (src/Shape.cpp:535-543).

    Solves A @ TB = E with A = [[du1, dv1], [du2, dv2]], E = [e1; e2].
    """
    du1 = det.uv1u - det.uv0u
    dv1 = det.uv1v - det.uv0v
    du2 = det.uv2u - det.uv0u
    dv2 = det.uv2v - det.uv0v
    det_a = du1 * dv2 - dv1 * du2
    # safe-div form (1/0 before the where would NaN the backward pass)
    ok = det_a != 0
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det_a, 1.0), 0.0)
    t_vec = (det.tri_e1 * dv2 - det.tri_e2 * dv1) * inv
    b_vec = (det.tri_e1 * (-du2) + det.tri_e2 * du1) * inv
    return t_vec, b_vec


def apply_textures(scene: T.Scene, det: HitDetails) -> TexturedHit:
    """Run the hit's texture list, producing decal state + final normal.

    Statically loops over the scene's textures; each lane applies a texture
    iff its tex0/tex1 slot references it, mirroring the per-object texture
    loop of src/Shape.cpp:400-616 (slot order preserved: tex0 then tex1).
    Normal-map math operates on the LOCAL-space normal exactly as the
    reference does (its texture step runs inside the BVH, pre-transform);
    the world transform by (M^-1)^T is applied once at the end, matching
    src/Helper.cpp:75-78.
    """
    N = det.normal.shape[0]
    dm = jnp.full((N,), T.DECAL_NONE, jnp.int32)
    tex_color = Vec3.zeros((N,))
    tex_norm = jnp.ones((N,))

    # All math below runs on the LOCAL-space normal; the reference textures
    # inside the per-object BVH step (src/Shape.cpp bvhIntersect) before the
    # world transform of the normal (src/Helper.cpp:75-78).
    cur_n = det.normal

    for slot in range(2):
        slot_ids = det.tex0 if slot == 0 else det.tex1
        for ti, tex in enumerate(scene.textures):
            decal, interp, ttype, nc = scene.texture_statics[ti]
            use = det.valid & (slot_ids == ti)
            if decal in (T.DECAL_NONE, T.DECAL_REPLACE_BACKGROUND):
                continue
            if ttype == T.TEX_IMAGE:
                if decal in (T.DECAL_REPLACE_KD, T.DECAL_BLEND_KD, T.DECAL_REPLACE_ALL):
                    color = sample_image(tex, det.u, det.v)
                    dm = jnp.where(use, decal, dm)
                    tex_color = vwhere(use, color, tex_color)
                    tex_norm = jnp.where(use, tex.normalizer, tex_norm)
                elif decal == T.DECAL_REPLACE_NORMAL:
                    # masked normalizes: non-``use`` lanes can hold zero
                    # vectors whose normalize VJP is 0*inf=NaN, poisoning
                    # texture gradients through the scatter-add (seen in
                    # the bump-grad FD test); forward bits on use lanes
                    # are unchanged.
                    rn = vmasked_normalize(
                        use, sample_image(tex, det.u, det.v) / 255.0 - 0.5)
                    dpdu_s, dpdv_s = _sphere_dp(det)
                    t_vec, b_vec = _tri_tb(det)
                    sph = use & det.is_sphere
                    tt = vwhere(det.is_sphere,
                                vmasked_normalize(sph, dpdu_s), t_vec)
                    bb = vwhere(det.is_sphere,
                                vmasked_normalize(sph, dpdv_s), b_vec)
                    # TBN columns: T, B, N (src/Shape.cpp:438-443,548-553);
                    # sphere T/B are normalized, triangle T/B are NOT.
                    newn = tt * rn.x + bb * rn.y + cur_n * rn.z
                    cur_n = vwhere(use, newn, cur_n)
                elif decal == T.DECAL_BUMP_NORMAL:
                    du, dv = sample_gradient(tex, det.u, det.v)
                    du = du * tex.bump_factor
                    dv = dv * tex.bump_factor
                    dpdu_s, dpdv_s = _sphere_dp(det)
                    t_vec, b_vec = _tri_tb(det)
                    tt = vwhere(det.is_sphere, dpdu_s, t_vec)
                    bb = vwhere(det.is_sphere, dpdv_s, b_vec)
                    dpu = tt + cur_n * du
                    dpv = bb + cur_n * dv
                    newn = vmasked_normalize(use, vcross(dpv, dpu))
                    # orient along the old normal (src/Shape.cpp:464-471)
                    flip = vdot(cur_n, newn) < 0
                    newn = vwhere(flip, -newn, newn)
                    cur_n = vwhere(use, newn, cur_n)
            else:  # Perlin
                if decal == T.DECAL_REPLACE_KD:
                    val = perlin_ops.perlin(det.local_point, tex.noise_scale, nc)
                    dm = jnp.where(use, T.DECAL_REPLACE_KD, dm)
                    tex_color = vwhere(use, Vec3(val, val, val), tex_color)
                    tex_norm = jnp.where(use, 1.0, tex_norm)
                elif decal == T.DECAL_BUMP_NORMAL:
                    g = perlin_ops.perlin_gradient(det.local_point,
                                                   tex.noise_scale, nc)
                    g_par = cur_n * vdot(g, cur_n)
                    newn = cur_n - (g - g_par) * tex.bump_factor
                    flip = vdot(cur_n, newn) < 0
                    newn = vwhere(flip, -newn, newn)
                    newn = vmasked_normalize(use, newn)
                    cur_n = vwhere(use, newn, cur_n)

    # world transform of the (possibly rewritten) local normal:
    # n_world = normalize((M^-1)^T n) once per hit (src/Helper.cpp:75-78).
    # Miss lanes carry a zero local normal whose normalize() is NaN — safe
    # under the forward masks, fatal in reverse mode; substitute a unit
    # vector there (masked_normalize) so dead lanes stay finite end to end.
    world_n = vmasked_normalize(det.valid, det.minv_t.apply(cur_n))

    return TexturedHit(dm=dm, tex_color=tex_color, tex_normalizer=tex_norm,
                       normal=world_n)
