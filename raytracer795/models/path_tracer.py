"""Monte Carlo path tracer (the reference's hw7, pages/Page7.md).

The reference documents — but its snapshot does not contain — a path tracer
with object/mesh lights, uniform + cosine importance sampling, next-event
estimation with the discard-the-BRDF-sample rule, and Russian roulette
(pages/Page7.md:7-33, 135-163). This module implements that capability
as a single `lax.fori_loop` over bounces where every pixel-sample
lane carries one continuation ray and a throughput, all decisions are masked
lane-math, and all light sampling is batched. All per-lane vectors are
lane-major Vec3 (utils/vec3.py).

Semantics:
- emission: rays see an emissive primitive's radiance when they hit it;
  with NEE on, emission is counted ONLY for camera rays and rays leaving
  specular vertices — diffuse-vertex BRDF samples that hit a light are
  discarded to avoid double counting (the pages/Page7.md:149 rule: discard
  the sample-direction contribution, keep NEE's).
- NEE at diffuse vertices: area-sample every object light. Sphere lights
  sample a uniform local-sphere point pushed through the light's transform
  with the |cof(M) n| area Jacobian (exact for ellipsoid lights); mesh
  lights sample triangles by area CDF. Occlusion compares hit distance to
  sample distance (the backface-shadow fix of pages/Page7.md:143). Classic
  point/directional/spot/area/environment lights contribute through the
  same direct-lighting code as the Whitted integrator.
- continuation: diffuse vertices sample the hemisphere uniformly
  (pdf 1/2pi) or cosine-weighted (pdf cos/pi) under ImportanceSampling;
  mirror/conductor continue the reflection with mirrorRef (x Fresnel);
  dielectrics pick reflect/refract with probability = Fresnel (one lane,
  unbiased) and apply Beer along internal segments — "reflected and
  refracted rays are treated as global illumination rays"
  (pages/Page7.md:155).
- termination: depth cap = MaxRecursionDepth bounces; RussianRoulette kills
  lanes with survival probability max(throughput) (the standard throughput
  method; the reference author used a cosine heuristic and notes throughput
  matches the course goldens, pages/Page7.md:31).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer795.models.brdf import _mat3_rows, term_brdf
from raytracer795.models.lights import ShadePoint, direct_lighting
from raytracer795.models.whitted import (_conductor_fresnel,
                                         _fresnel_dielectric,
                                         _glossy_perturb, _refract)
from raytracer795.ops import intersect
from raytracer795.ops.texture import apply_textures
from raytracer795.scene import types as T
from raytracer795.utils.vec3 import (Vec3, const_mat3_apply, vany_nan,
                                     vcross, vdot, vnorm, vnormalize,
                                     vorthonormal_u, vreflect,
                                     vsafe_normalize, vscrub_nan, vwhere)
from raytracer795.utils.vecmath import safe_pow


class _PTState(NamedTuple):
    net: jnp.ndarray        # scalar int32 survivor-weighted ray count
    active: jnp.ndarray     # [N]
    count_emission: jnp.ndarray  # [N] ray may collect emission at next hit
    o: Vec3
    d: Vec3
    time: jnp.ndarray       # [N]
    thru: Vec3
    sigma: Vec3             # Beer coefficient for current segment
    pixel: jnp.ndarray      # [N] output slot of this lane (compaction)
    radiance: Vec3
    key: jax.Array


def _pt_brdf(wi: Vec3, wo: Vec3, normal: Vec3, mats, mat_idx) -> Vec3:
    """BRDF for path tracing.

    Materials with an explicit BRDF use the reference's 8 models
    (src/Light.cpp:62-155). Plain materials use the shading-contract
    diffuse+specular pair normalized for energy conservation
    (kd/pi + ks (p+8)/(8 pi) (n.h)^p — the normalized Blinn-Phong of
    src/Light.cpp:112-121): the reference's unnormalized direct-lighting
    formula (plain kd) is not a valid pdf-weighted BRDF and would make the
    Monte Carlo estimator gain energy each bounce.
    """
    f = term_brdf(wi, wo, normal, mats, mat_idx)
    kd = _mat3_rows(mats.diffuse, mat_idx)
    ks = _mat3_rows(mats.specular, mat_idx)
    pexp = mats.phong[mat_idx]
    h = vsafe_normalize(wo + wi)    # wi == -wo on dead lanes => |h| == 0
    cos_h = jnp.maximum(0.0, vdot(normal, h))
    pi = jnp.pi
    f_plain = kd / pi + ks * (((pexp + 8.0) / (8.0 * pi))
                              * safe_pow(cos_h, pexp))
    none = mats.brdf[mat_idx] == T.BRDF_NONE
    return vwhere(none, f_plain, f)


def _sample_hemisphere(n: Vec3, chi0, chi1, importance: bool):
    """Direction + pdf around normal n. chi0/chi1 [N] uniforms."""
    u = vorthonormal_u(n)
    w = vcross(n, u)
    phi = chi1 * 2.0 * jnp.pi
    if importance:
        # cosine-weighted: pdf = cos/pi
        r = jnp.sqrt(chi0)
        z = jnp.sqrt(jnp.maximum(0.0, 1.0 - chi0))
        d = u * (r * jnp.cos(phi)) + w * (r * jnp.sin(phi)) + n * z
        pdf = jnp.maximum(z / jnp.pi, 1e-8)
    else:
        # uniform: pdf = 1/(2pi)
        z = chi0
        r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
        d = u * (r * jnp.cos(phi)) + w * (r * jnp.sin(phi)) + n * z
        pdf = jnp.full(z.shape, 1.0 / (2.0 * jnp.pi))
    return vnormalize(d), pdf


def _object_light_nee(scene: T.Scene, sp: ShadePoint, key) -> Vec3:
    """Direct contribution of all object lights via area sampling."""
    N = sp.time.shape[0]
    out = Vec3.zeros((N,))
    mats = scene.materials
    eps = scene.shadow_eps

    def shade_from_sample(lpos: Vec3, lnormal: Vec3, radiance, pdf_area, li):
        to_l = lpos - sp.point
        d2 = vdot(to_l, to_l)
        # guarded sqrt/division: dead lanes can have sample == point
        dist = jnp.sqrt(jnp.where(d2 > 0, d2, 1.0))
        dist = jnp.where(d2 > 0, dist, 1.0)
        wi = to_l * (1.0 / dist)
        # occlusion: any hit strictly closer than the sample point (the
        # backface-shadow fix of pages/Page7.md:143). Distance-compare
        # |eps*n + t*wi| < dist - 2*eps solved for the exact t_cap; fully
        # stop-gradient — visibility is discrete.
        sg = jax.lax.stop_gradient
        o = sp.point + sp.normal * eps
        c = sg(vdot(sp.normal, wi))
        dlim = sg(dist) - 2.0 * eps
        rad = jnp.maximum(eps * eps * (c * c - 1.0) + dlim * dlim, 0.0)
        t_cap = -eps * c + jnp.sqrt(rad)
        occluded = intersect.trace_anyhit(
            scene, intersect.Rays(o=o, d=wi, time=sp.time), t_cap)
        visible = ~occluded
        cos_x = jnp.maximum(0.0, vdot(sp.normal, wi))
        cos_l = jnp.abs(vdot(lnormal, -wi))
        f = _pt_brdf(wi, sp.wo, sp.normal, mats, sp.mat)
        geom = cos_x * cos_l / jnp.maximum(d2, 1e-12)
        scale = geom / jnp.maximum(pdf_area, 1e-12)
        contrib = Vec3(radiance[0] * f.x, radiance[1] * f.y,
                       radiance[2] * f.z) * scale
        return vwhere(visible & sp.valid, contrib, 0.0)

    idx = 0
    for sl in scene.sphere_lights:
        k = jax.random.fold_in(key, 7000 + idx)
        chi = jax.random.uniform(k, (2, N))
        z = 1.0 - 2.0 * chi[0]
        r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
        phi = 2.0 * jnp.pi * chi[1]
        n_l = Vec3(r * jnp.cos(phi), z, r * jnp.sin(phi))
        p_local = Vec3(sl.center[0] + sl.radius * n_l.x,
                       sl.center[1] + sl.radius * n_l.y,
                       sl.center[2] + sl.radius * n_l.z)
        if sl.has_xform:
            p_world = const_mat3_apply(sl.m, p_local) + Vec3(
                sl.m[0, 3], sl.m[1, 3], sl.m[2, 3])
            cof_n = const_mat3_apply(sl.cof, n_l)
            jac = vnorm(cof_n)
            n_world = vnormalize(cof_n)
        else:
            p_world = p_local
            jac = jnp.ones((N,))
            n_world = n_l
        area_local = 4.0 * jnp.pi * sl.radius * sl.radius
        pdf_area = 1.0 / (area_local * jac)
        out = out + shade_from_sample(p_world, n_world, sl.radiance,
                                      pdf_area, idx)
        idx += 1

    for ml in scene.mesh_lights:
        k = jax.random.fold_in(key, 7000 + idx)
        chi = jax.random.uniform(k, (3, N))
        ti = jnp.searchsorted(ml.cdf, chi[0])
        ti = jnp.clip(ti, 0, ml.a.shape[0] - 1)
        # uniform barycentric (sqrt trick)
        su = jnp.sqrt(chi[1])
        b1 = 1.0 - su
        b2 = chi[2] * su
        b0 = 1.0 - b1 - b2
        av = Vec3.from_array(ml.a)
        bv = Vec3.from_array(ml.b)
        cv = Vec3.from_array(ml.c)
        p = (Vec3(av.x[ti], av.y[ti], av.z[ti]) * b0
             + Vec3(bv.x[ti], bv.y[ti], bv.z[ti]) * b1
             + Vec3(cv.x[ti], cv.y[ti], cv.z[ti]) * b2)
        nv = Vec3.from_array(ml.normal)
        n_l = Vec3(nv.x[ti], nv.y[ti], nv.z[ti])
        pdf_area = jnp.full((N,), 1.0 / jnp.maximum(ml.total_area, 1e-12))
        out = out + shade_from_sample(p, n_l, ml.radiance, pdf_area, idx)
        idx += 1

    return out


def render_rays(scene: T.Scene, rays: intersect.Rays,
                bg_radiance, key: jax.Array,
                with_stats: bool = False) -> jnp.ndarray:
    """Path-trace a batch of camera rays to radiance [N, 3].

    ``with_stats=True`` returns ``(radiance, net_rays)``: net_rays is the
    scalar int32 count of rays traced by LIVE lanes only (extension rays of
    active lanes + NEE/classic shadow rays of diffuse-shaded lanes) — the
    survivor-weighted number beside bench.py's device-throughput gross
    count, which bills every masked lane for full depth.
    """
    # host (numpy) scene leaves cannot be indexed by traced lane ids
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    if not isinstance(bg_radiance, Vec3):
        bg_radiance = Vec3.from_array(jnp.asarray(bg_radiance))
    N = rays.o.shape[0]
    mats = scene.materials
    vertex_normals = intersect.compute_vertex_normals(scene)
    max_bounces = max(scene.max_depth, 1)
    has_object_lights = bool(scene.sphere_lights or scene.mesh_lights)

    # shadow-ray sources per diffuse-shaded lane: every object light when
    # NEE is on, plus each classic light (and env) via direct_lighting
    n_obj_nee = (len(scene.sphere_lights) + len(scene.mesh_lights)) \
        if (scene.pt_nee and has_object_lights) else 0
    n_classic = int(scene.lights.point_pos.shape[0]
                    + scene.lights.dir_dir.shape[0]
                    + scene.lights.spot_pos.shape[0]
                    + scene.lights.area_pos.shape[0]) \
        + (1 if scene.env_texture >= 0 else 0)
    n_shadow_lights = n_obj_nee + n_classic

    state = _PTState(
        net=jnp.int32(0),
        active=jnp.ones((N,), bool),
        count_emission=jnp.ones((N,), bool),
        o=rays.o, d=rays.d, time=rays.time,
        thru=Vec3.ones((N,)),
        sigma=Vec3.zeros((N,)),
        radiance=Vec3.zeros((N,)),
        pixel=jnp.arange(N, dtype=jnp.int32),
        key=key,
    )
    # Stream-compaction option (SURVEY §5 long-context analogue / the
    # Phase-3 mitigation list), RT795_PT_COMPACT=1: sort lanes by liveness
    # after each bounce so dead lanes cluster into whole traversal
    # programs, which then finish at once. It costs ~17 per-bounce [N]-lane
    # argsort+gathers, and all shading math stays full-width masked ops
    # whatever the lane order. Off by default; not measured on this card.
    compact = os.environ.get("RT795_PT_COMPACT") == "1"

    def bounce(i, s: _PTState) -> _PTState:
        k_iter = jax.random.fold_in(s.key, i)
        # dead lanes keep their last ray — zero their direction so the
        # traversal kernels retire them at entry (idle blocks early-exit)
        # while reverse mode stays finite (see whitted.py)
        d_t = vwhere(s.active, s.d, Vec3.zeros((N,)))
        wrays = intersect.Rays(o=s.o, d=d_t, time=s.time)
        hit = intersect.trace(scene, wrays)
        hit_valid = hit.valid & s.active
        det = intersect.hit_details(scene, wrays, hit, vertex_normals)
        det = det._replace(valid=hit_valid)
        tex = apply_textures(scene, det)
        normal = tex.normal

        # Beer attenuation of the resolved segment (det.t = differentiable
        # recompute of hit.t, same bits)
        seg_t = jnp.where(hit_valid, det.t, 0.0)
        thru = s.thru * Vec3(jnp.exp(-s.sigma.x * seg_t),
                             jnp.exp(-s.sigma.y * seg_t),
                             jnp.exp(-s.sigma.z * seg_t))

        radiance = s.radiance
        # primary-miss background (secondary misses contribute nothing,
        # matching the Whitted convention src/Scene.cpp:150-153)
        miss = s.active & ~hit_valid
        radiance = radiance + vwhere(miss & (i == 0), bg_radiance, 0.0)

        # emission at the hit (double-count rule)
        emit_ok = hit_valid & s.count_emission
        radiance = radiance + vwhere(emit_ok, thru * det.emission, 0.0)

        mat_idx = det.mat
        mtype = mats.mtype[mat_idx]
        is_diffuse = hit_valid & (mtype == T.MAT_NORMAL)
        is_mirror = hit_valid & (mtype == T.MAT_MIRROR)
        is_conductor = hit_valid & (mtype == T.MAT_CONDUCTOR)
        is_dielectric = hit_valid & (mtype == T.MAT_DIELECTRIC)

        # net (survivor-weighted) ray accounting — statically gated, the
        # timed render path (with_stats=False) compiles without the
        # per-bounce cross-lane reductions (see whitted.py)
        if with_stats:
            net = (s.net + jnp.sum(s.active.astype(jnp.int32))
                   + n_shadow_lights * jnp.sum(is_diffuse.astype(jnp.int32)))
        else:
            net = s.net

        # ---- NEE + classic lights at diffuse vertices ----
        sp = ShadePoint(point=det.point, normal=normal, wo=-s.d, mat=mat_idx,
                        dm=tex.dm, tex_color=tex.tex_color,
                        tex_norm=tex.tex_normalizer, time=s.time,
                        valid=is_diffuse)
        if scene.pt_nee and has_object_lights:
            nee = _object_light_nee(scene, sp, jax.random.fold_in(k_iter, 1))
            radiance = radiance + vscrub_nan(
                vwhere(is_diffuse, thru * nee, 0.0))
        # classic lights (and ambient) always via direct lighting
        classic = direct_lighting(scene, sp, jax.random.fold_in(k_iter, 2))
        radiance = radiance + vscrub_nan(
            vwhere(is_diffuse, thru * classic, 0.0))

        # ---- continuations ----
        eps = scene.shadow_eps
        chi = jax.random.uniform(jax.random.fold_in(k_iter, 3), (6, N))

        # diffuse: hemisphere sample
        d_diff, pdf = _sample_hemisphere(normal, chi[0], chi[1],
                                         scene.pt_importance)
        f = _pt_brdf(d_diff, -s.d, normal, mats, mat_idx)
        cos_s = jnp.maximum(0.0, vdot(d_diff, normal))
        w_diff = f * (cos_s / pdf)

        # specular shared math
        wr = vreflect(s.d, normal)
        wr = _glossy_perturb(wr, mats.roughness[mat_idx],
                             mats.is_rough[mat_idx],
                             chi[4] - 0.5, chi[5] - 0.5)
        f_cond = _conductor_fresnel(mats.refraction[mat_idx],
                                    mats.absorption_index[mat_idx], s.d, normal)
        # snell guarded on non-dielectric lanes (refraction index may be 0)
        nt = mats.refraction[mat_idx]
        diel = mtype == T.MAT_DIELECTRIC
        nt_s = jnp.where(diel, nt, 1.0)
        entering = vdot(s.d, normal) < 0
        no = vwhere(entering, normal, -normal)
        snell = jnp.where(entering, 1.0 / nt_s, nt_s)
        t_dir, tir = _refract(s.d, no, snell, diel)
        n_t = jnp.where(entering, nt_s, 1.0)
        n_i = jnp.where(entering, 1.0, nt_s)
        fr = _fresnel_dielectric(n_t, n_i, s.d, t_dir, no)
        fr = jnp.where(tir, 1.0, fr)
        absorb = _mat3_rows(mats.absorption_coef, mat_idx)
        # stochastic branch pick: reflect with prob fr (weight cancels)
        pick_reflect = chi[3] < fr
        diel_d = vwhere(pick_reflect | tir, wr, t_dir)
        diel_o = vwhere(pick_reflect | tir,
                        det.point + normal * eps, det.point - no * eps)
        # Beer applies when the NEXT segment runs inside the medium:
        # entering+refract, or internal reflection (TIR / exit+reflect pick)
        diel_sigma_on = (entering & ~pick_reflect) | (~entering & (tir | pick_reflect))
        diel_sigma = vwhere(diel_sigma_on, absorb, 0.0)

        new_d = vwhere(is_diffuse, d_diff,
                       vwhere(is_dielectric, diel_d, wr))
        new_o = vwhere(is_dielectric, diel_o, det.point + normal * eps)
        mfac = _mat3_rows(mats.mirror, mat_idx)
        w_next = vwhere(is_diffuse, w_diff,
                        vwhere(is_mirror, mfac,
                               vwhere(is_conductor, mfac * f_cond,
                                      Vec3.ones((N,)))))
        sigma_next = vwhere(is_dielectric, diel_sigma, 0.0)

        thru = thru * vwhere(hit_valid, w_next, 1.0)

        # with NEE, diffuse-vertex BRDF samples must NOT re-collect emission
        count_next = jnp.where(is_diffuse, not scene.pt_nee, True)

        cont = hit_valid & (i + 1 < max_bounces)
        bad = vany_nan(new_d) | vany_nan(thru)
        cont = cont & ~bad
        # drop dead-throughput lanes
        thru_max = jnp.maximum(thru.x, jnp.maximum(thru.y, thru.z))
        cont = cont & (thru_max > 1e-6)

        # Russian roulette (throughput survival)
        if scene.pt_rr:
            q = jnp.clip(thru_max, 0.05, 1.0)
            u = jax.random.uniform(jax.random.fold_in(k_iter, 4), (N,))
            live = u < q
            apply_rr = cont & (i >= 1)
            thru = vwhere(apply_rr & live, thru * (1.0 / q), thru)
            cont = jnp.where(apply_rr, cont & live, cont)

        ns = _PTState(
            net=net,
            active=cont,
            count_emission=count_next,
            o=vwhere(cont, new_o, s.o),
            d=vwhere(cont, new_d, s.d),
            time=s.time,
            thru=thru,
            sigma=vwhere(cont, sigma_next, s.sigma),
            radiance=radiance,
            pixel=s.pixel,
            key=s.key,
        )
        if compact:
            perm = jnp.argsort(~ns.active, stable=True)
            ns = jax.tree_util.tree_map(
                lambda x: x[perm]
                if getattr(x, "ndim", 0) >= 1 and x.shape[0] == N else x, ns)
        return ns

    # Without RR the loop runs exactly max_bounces; with RR lanes die early
    # but the bound is the same (the RR kill only shortens work, and the
    # fori_loop keeps the schedule static for XLA). The body is checkpointed
    # so reverse mode rematerializes each bounce instead of saving every
    # wavefront intermediate.
    bounce_ckpt = jax.checkpoint(bounce, static_argnums=())
    final = jax.lax.fori_loop(0, max_bounces, bounce_ckpt, state)
    out = final.radiance.to_array()
    if compact:        # un-permute lanes back to pixel order
        out = jnp.zeros_like(out).at[final.pixel].set(out)
    if with_stats:
        return out, final.net
    return out
