"""Direct lighting: ambient + per-light diffuse/specular/BRDF with shadows.

Contract: Light::BasicShading per type (src/Light.cpp:238-250, 309-321,
409-436, 522-545, 628-660) and Scene::BasicShading/ambient
(src/Scene.cpp:22-30, 243-267). Shadow rays re-enter the same wavefront
trace (one batched occlusion query per light). All per-lane vectors are
lane-major Vec3 (utils/vec3.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from raytracer795.models.brdf import (_mat3_rows, gather_brdf_rec,
                                           term_brdf_rec)
from raytracer795.ops import intersect
from raytracer795.ops.texture import sample_image
from raytracer795.scene import types as T
from raytracer795.utils.vec3 import (Vec3, vcross, vdot, vnorm,
                                     vnormalize, vorthonormal_u,
                                     vsafe_normalize, vwhere)
from raytracer795.utils.vecmath import safe_pow

_sg = jax.lax.stop_gradient


class ShadePoint(NamedTuple):
    """Per-lane inputs to direct lighting."""
    point: Vec3             # world hit point
    normal: Vec3            # world shading normal (post-texture)
    wo: Vec3                # unit vector toward the viewer
    mat: jnp.ndarray        # [N] int32
    dm: jnp.ndarray         # [N] int32 decal mode
    tex_color: Vec3
    tex_norm: jnp.ndarray   # [N]
    time: jnp.ndarray       # [N] ray time (shadow rays inherit it)
    valid: jnp.ndarray      # [N] bool


class _ShadeRec(NamedTuple):
    """Per-lane material rows gathered ONCE per direct_lighting call and
    reused by every light (the per-light gathers were the single largest
    non-kernel cost of a multi-light frame)."""

    kd_eff: Vec3        # diffuse after decal modes (src/Light.cpp:206-223)
    ks: Vec3
    p: jnp.ndarray
    brdf: Any           # BrdfRec | None when the scene has no BRDF materials


def _shade_rec(scene: T.Scene, sp: ShadePoint) -> _ShadeRec:
    mats = scene.materials
    kd = _mat3_rows(mats.diffuse, sp.mat)
    tex = sp.tex_color * (1.0 / sp.tex_norm)
    kd_eff = vwhere(sp.dm == T.DECAL_REPLACE_KD, tex, kd)
    kd_eff = vwhere(sp.dm == T.DECAL_BLEND_KD, (kd + tex) * 0.5, kd_eff)
    brdf = gather_brdf_rec(mats, sp.mat) if scene.any_brdf else None
    return _ShadeRec(kd_eff=kd_eff, ks=_mat3_rows(mats.specular, sp.mat),
                     p=mats.phong[sp.mat], brdf=brdf)


def _lit_color(sp: ShadePoint, rec: _ShadeRec, wi: Vec3,
               contribution: Vec3) -> Vec3:
    """BRDF vs Blinn-Phong diffuse+specular per lane (src/Light.cpp:243-249).

    The 8-model BRDF blend is skipped entirely (statically) when no
    material references a BRDF — its selection mask would be all-False.
    """
    cos_i = jnp.maximum(0.0, vdot(sp.normal, wi))
    diffuse = contribution * rec.kd_eff * cos_i
    h = vsafe_normalize(sp.wo + wi)     # wi == -wo on dead lanes
    cos_h = jnp.maximum(0.0, vdot(sp.normal, h))
    specular = contribution * rec.ks * safe_pow(cos_h, rec.p)
    via_ds = diffuse + specular
    if rec.brdf is None:
        return via_ds
    f = term_brdf_rec(wi, sp.wo, sp.normal, rec.brdf)
    via_brdf = contribution * f * cos_i     # L*f*cos (src/Light.cpp:157-162)
    return vwhere(rec.brdf.btype != T.BRDF_NONE, via_brdf, via_ds)


def _occluded(scene: T.Scene, sp: ShadePoint, direction: Vec3, d_light=None):
    """Shadow test via the any-hit query.

    Origin offset along the surface normal (src/Light.cpp:192; the
    pages/Page2.md:87 bugfix). The reference compares the occluder's
    distance FROM THE HIT POINT against the light distance
    (src/Light.cpp:197-200): with o = p + eps*n that is
    |eps*n + t*d| < d_light, i.e. t < t_cap for
    t_cap = -eps*c + sqrt(eps^2*(c^2 - 1) + d_light^2), c = n.d —
    solved exactly so the any-hit reproduces the distance-compare
    semantics. ``d_light=None`` means any hit occludes (directional).

    NEGATIVE RESULT (measured, not adopted): batching EVERY light's shadow
    query of a bounce into ONE [L*N]-lane trace_anyhit launch (shared
    origins tiled, per-light directions/caps concatenated) was bit-exact
    but perf-flat on all three mesh benches — dragon frame 0.862 vs
    0.856 s, rock100k 32.5 vs 32.5 M rays/s, instances_rock 5.07 vs
    5.13 M — the per-launch fixed cost this targeted is already amortized
    by the launch sizes render.py's MAX_LANES picks, so the per-light
    calls stay (simpler, and the TLAS culls per-light corridors anyway).
    """
    eps = scene.shadow_eps
    # lanes with no valid shade point (misses, idle wavefront lanes) carry
    # finite garbage geometry — their shadow rays would walk the BVH for
    # nothing. A zero direction kills them at kernel entry (idle blocks
    # exit immediately) while staying finite for reverse mode; the result
    # is masked by sp.valid downstream anyway.
    o = jax.tree_util.tree_map(_sg, sp.point + sp.normal * eps)
    zero = Vec3.zeros(sp.time.shape)
    direction = vwhere(sp.valid, direction, zero)
    if d_light is None:
        t_cap = jnp.float32(3.0e38)
    else:
        c = _sg(vdot(sp.normal, direction))
        d2 = _sg(d_light * d_light)
        rad = jnp.maximum(eps * eps * (c * c - 1.0) + d2, 0.0)
        t_cap = -eps * c + jnp.sqrt(rad)
    rays = intersect.Rays(o=o, d=direction, time=sp.time)
    return intersect.trace_anyhit(scene, rays, t_cap)


def direct_lighting(scene: T.Scene, sp: ShadePoint, key: jax.Array) -> Vec3:
    """Ambient + sum over all lights (Scene::BasicShading)."""
    mats = scene.materials
    amb = scene.lights.ambient
    mamb = _mat3_rows(mats.ambient, sp.mat)
    out = Vec3(amb[0] * mamb.x, amb[1] * mamb.y, amb[2] * mamb.z)
    # (src/Scene.cpp:22-30)
    rec = _shade_rec(scene, sp)

    lights = scene.lights
    N = sp.time.shape[0]

    # ---- point lights (src/Light.cpp:166-250) ----
    for i in range(lights.point_pos.shape[0]):
        pos = lights.point_pos[i]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        wi = topoint * (1.0 / d_light)
        shadowed = _occluded(scene, sp, wi, d_light)  # src/Light.cpp:197-200
        inten = lights.point_intensity[i]
        inv_d2 = 1.0 / (d_light * d_light)
        contribution = Vec3(inten[0] * inv_d2, inten[1] * inv_d2,
                            inten[2] * inv_d2)
        lit = _lit_color(sp, rec, wi, contribution)
        out = out + vwhere(sp.valid & ~shadowed, lit, 0.0)

    # ---- directional lights (src/Light.cpp:256-321) ----
    for i in range(lights.dir_dir.shape[0]):
        dd = lights.dir_dir[i]
        ones = jnp.ones((N,))
        wi = Vec3(-dd[0] * ones, -dd[1] * ones, -dd[2] * ones)
        occ = _occluded(scene, sp, wi, None)
        rad = lights.dir_radiance[i]
        contribution = Vec3(rad[0] * ones, rad[1] * ones, rad[2] * ones)
        lit = _lit_color(sp, rec, wi, contribution)
        out = out + vwhere(sp.valid & ~occ, lit, 0.0)

    # ---- spot lights (src/Light.cpp:327-436) ----
    for i in range(lights.spot_pos.shape[0]):
        pos = lights.spot_pos[i]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        wi = topoint * (1.0 / d_light)
        shadowed = _occluded(scene, sp, wi, d_light)
        inten = lights.spot_intensity[i]
        inv_d2 = 1.0 / (d_light * d_light)
        contribution = Vec3(inten[0] * inv_d2, inten[1] * inv_d2,
                            inten[2] * inv_d2)
        lit = _lit_color(sp, rec, wi, contribution)
        # falloff (src/Light.cpp:338-348, 409-436); double-where: dead lanes
        # clip to +/-1 where arccos' derivative is infinite
        sd = lights.spot_dir[i]
        cos_a = jnp.clip(-(wi.x * sd[0] + wi.y * sd[1] + wi.z * sd[2]),
                         -1.0, 1.0)
        angle = jnp.arccos(jnp.where(sp.valid, cos_a, 0.0))
        cf = jnp.cos(lights.spot_falloff[i])
        cc = jnp.cos(lights.spot_coverage[i])
        factor = ((jnp.cos(angle) - cc) / (cf - cc)) ** 4
        scale = jnp.where(angle < lights.spot_falloff[i], 1.0,
                          jnp.where(angle < lights.spot_coverage[i], factor, 0.0))
        out = out + vwhere(sp.valid & ~shadowed, lit * scale, 0.0)

    # ---- area lights (src/Light.cpp:442-545) ----
    for i in range(lights.area_pos.shape[0]):
        k = jax.random.fold_in(key, 1000 + i)
        chi = jax.random.uniform(k, (2, N)) - 0.5
        size = lights.area_size[i]
        pos = lights.area_pos[i]
        au = lights.area_u[i]
        av = lights.area_v[i]
        sample = Vec3(pos[0] + au[0] * size * chi[0] + av[0] * size * chi[1],
                      pos[1] + au[1] * size * chi[0] + av[1] * size * chi[1],
                      pos[2] + au[2] * size * chi[0] + av[2] * size * chi[1])
        tosample = sample - sp.point
        d_light = vnorm(tosample)
        wi = tosample * (1.0 / d_light)
        shadowed = _occluded(scene, sp, wi, d_light)
        # factor = size^2 cos/d^2 (src/Light.cpp:457-463)
        an = lights.area_normal[i]
        cos_l = jnp.abs(-(wi.x * an[0] + wi.y * an[1] + wi.z * an[2]))
        factor = (size * size) * cos_l / (d_light * d_light)
        rad = lights.area_radiance[i]
        contribution = Vec3(rad[0] * factor, rad[1] * factor, rad[2] * factor)
        lit = _lit_color(sp, rec, wi, contribution)
        out = out + vwhere(sp.valid & ~shadowed, lit, 0.0)

    # ---- environment light (src/Light.cpp:551-660) ----
    if scene.env_texture >= 0:
        k = jax.random.fold_in(key, 2000)
        n = sp.normal
        u = vorthonormal_u(n)
        w = vcross(n, u)
        chi = jax.random.uniform(k, (2, N))
        # The reference rejection-samples uniform directions in the normal
        # hemisphere (src/Light.cpp:634-648); sample the same distribution
        # directly: z ~ U(0,1), phi ~ U(0,2pi), pdf = 1/(2pi).
        z = chi[0]
        phi = chi[1] * 2.0 * jnp.pi
        r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
        wi = vnormalize(u * (r * jnp.cos(phi)) + n * z
                        + w * (r * jnp.sin(phi)))
        occ = _occluded(scene, sp, wi, None)
        radiance = env_radiance(scene, wi) * (2.0 * jnp.pi)
        lit = _lit_color(sp, rec, wi, radiance)
        out = out + vwhere(sp.valid & ~occ, lit, 0.0)

    return out


def env_radiance(scene: T.Scene, direction: Vec3) -> Vec3:
    """Lat-long environment lookup (src/Light.cpp:563-575)."""
    theta = jnp.arccos(jnp.clip(direction.y, -1.0, 1.0))
    phi = jnp.arctan2(direction.z, direction.x)
    u = (-phi + jnp.pi) / (2.0 * jnp.pi)
    v = theta / jnp.pi
    tex = scene.textures[scene.env_texture]
    return sample_image(tex, u, v)
