"""Whitted integrator as an iterative masked-lane machine.

The reference shades by recursion (Scene::RecursiveShading,
src/Scene.cpp:148-219): mirror/conductor spawn one child ray, dielectrics
split into a reflected and a refracted child weighted by Fresnel, Beer's law
attenuates the segment inside the medium, and every surface event except a
dielectric exit also emits direct lighting (BasicShading).

Here every pixel-sample is a lane carrying one current ray
plus a small per-lane stack of deferred branch rays (stack-major [D, N]
arrays, D = max recursion depth, so the lane axis stays the minor axis). One loop iteration intersects ALL current rays as a wavefront,
accumulates emissions into the lane's radiance with the running throughput,
and either continues the lane with a child ray, pops a deferred ray, or
retires the lane. The loop ends when every lane is idle — total iterations
equal the deepest lane's ray-tree size, and every iteration is fully
vectorized (no per-ray recursion, no divergence beyond lane masks).

Event table (depth = remaining recursion budget at the hit):
  miss, primary lane        -> emit background (src/Scene.cpp:378-381)
  miss, secondary lane      -> emit nothing    (src/Scene.cpp:150-153)
  ReplaceAll decal, primary -> emit texture color (src/Scene.cpp:232-234)
  Normal mat or depth <= 0  -> emit BasicShading; retire (src/Scene.cpp:155-157)
  Mirror                    -> emit BasicShading; continue reflect * mirrorRef
  Conductor                 -> emit BasicShading; continue reflect * mirrorRef * F
  Dielectric enter          -> emit BasicShading; continue refract * (1-F) with
                               Beer sigma; push reflect * F
  Dielectric exit, TIR      -> continue reflect with Beer sigma (no emission)
  Dielectric exit, no TIR   -> continue refract * (1-F); push reflect * F with
                               Beer sigma (no emission)

Beer handling: the child's first segment length is unknown until the NEXT
iteration's trace, so each lane carries the active absorption coefficient and
throughput is multiplied by exp(-sigma * t) right after its segment resolves
— algebraically identical to the reference's beer-on-subtree factor
(src/Scene.cpp:108-117,170-207). Deviation (documented): on dielectric-exit
events the reference attenuates the INTERNAL reflected branch by the length
of the *refracted* segment (src/Scene.cpp:110 computes beerDistance from the
refraction ray for both branches); we use the reflected branch's own segment
length, which is the physically consistent reading.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer795.models.brdf import _mat3_rows
from raytracer795.models.lights import ShadePoint, direct_lighting
from raytracer795.ops import intersect
from raytracer795.ops.texture import apply_textures
from raytracer795.scene import types as T
from raytracer795.utils.vec3 import (Vec3, vany_nan, vcross, vdot,
                                     vmasked_normalize, vorthonormal_u,
                                     vreflect, vsafe_normalize,
                                     vscrub_nan, vwhere)
from raytracer795.utils.vecmath import safe_div


class _State(NamedTuple):
    it: jnp.ndarray             # scalar int32 iteration counter
    net: jnp.ndarray            # scalar int32 survivor-weighted ray count
    active: jnp.ndarray         # [N] lane has a current ray
    is_primary: jnp.ndarray     # [N] current ray is the camera ray
    o: Vec3                     # [N] x3
    d: Vec3
    time: jnp.ndarray           # [N]
    thru: Vec3
    depth: jnp.ndarray          # [N] remaining recursion budget
    sigma: Vec3                 # Beer coefficient of current segment
    radiance: Vec3              # accumulator
    # per-lane stacks, stack-major [D, N]
    sp: jnp.ndarray             # [N]
    st_o: Vec3                  # [D, N] x3
    st_d: Vec3
    st_thru: Vec3
    st_depth: jnp.ndarray       # [D, N]
    st_sigma: Vec3


def _glossy_perturb(wr: Vec3, roughness, is_rough, chi0, chi1) -> Vec3:
    """Rough-mirror jitter (src/Scene.cpp:41-47)."""
    u = vorthonormal_u(wr)
    v = vcross(wr, u)
    wr2 = vsafe_normalize(wr + (u * chi0 + v * chi1) * roughness)
    return vwhere(is_rough, wr2, wr)


def _fresnel_dielectric(n_t, n_i, d: Vec3, t_dir: Vec3, no: Vec3):
    """Dielectric Fresnel (src/Scene.cpp:120-128).

    Denominators guarded: non-dielectric lanes evaluate this with garbage
    (possibly zero) indices; a raw 1/0 would NaN reverse mode through the
    downstream masks.
    """
    cos_t = -vdot(t_dir, no)
    cos_i = -vdot(d, no)
    r_par = safe_div(n_t * cos_i - n_i * cos_t, n_t * cos_i + n_i * cos_t)
    r_perp = safe_div(n_i * cos_i - n_t * cos_t, n_i * cos_i + n_t * cos_t)
    return 0.5 * (r_par * r_par + r_perp * r_perp)


def _conductor_fresnel(n_t, k_t, d: Vec3, n: Vec3):
    """Conductor Fresnel (src/Scene.cpp:135-146); guarded like the above."""
    cos_t = -vdot(d, n)
    two = 2.0 * n_t * cos_t
    cos2 = cos_t * cos_t
    nk2 = n_t * n_t + k_t * k_t
    rs = safe_div(nk2 - two + cos2, nk2 + two + cos2)
    rp = safe_div(nk2 * cos2 - two + 1.0, nk2 * cos2 + two + 1.0)
    return 0.5 * (rs + rp)


def _refract(d: Vec3, no: Vec3, snell, diel_mask):
    """Snell refraction direction + TIR mask (src/Scene.cpp:57-117).

    ``diel_mask`` marks lanes whose material really is dielectric; other
    lanes run this math on garbage (snell can be inf when refraction index
    is 0) and are sanitized so reverse mode stays finite. Live-lane forward
    bits are unchanged.
    """
    snell = jnp.where(diel_mask, snell, 1.0)
    cos_i = -vdot(d, no)
    sqrt_part = 1.0 - snell * snell * (1.0 - cos_i * cos_i)
    tir = sqrt_part < 0
    # sqrt guarded at 0 (its VJP is 1/(2 sqrt) = inf); <=0 lanes return 0,
    # exactly what sqrt(max(part, 0)) produced.
    root = jnp.sqrt(jnp.where(sqrt_part > 0, sqrt_part, 1.0)) * (sqrt_part > 0)
    t_raw = (d + no * cos_i) * snell - no * root
    t_dir = vmasked_normalize(diel_mask & ~tir, t_raw)
    return t_dir, tir


def _pick_row(st, spi, D):
    """Per-lane stack read: st[spi[i], i] via an unrolled D-way select."""
    got = st[0]
    for k in range(1, D):
        got = jnp.where(spi == k, st[k], got)
    return got


def _pick_row3(st: Vec3, spi, D) -> Vec3:
    return Vec3(_pick_row(st.x, spi, D), _pick_row(st.y, spi, D),
                _pick_row(st.z, spi, D))


def _put_row(st, sp, mask, val, D):
    """Per-lane stack write at slot sp where ``mask``."""
    return jnp.stack([jnp.where((sp == k) & mask, val, st[k])
                      for k in range(D)], axis=0)


def _put_row3(st: Vec3, sp, mask, val: Vec3, D) -> Vec3:
    return Vec3(_put_row(st.x, sp, mask, val.x, D),
                _put_row(st.y, sp, mask, val.y, D),
                _put_row(st.z, sp, mask, val.z, D))


def render_rays(scene: T.Scene, rays: intersect.Rays,
                bg_radiance, key: jax.Array,
                differentiable: bool = True,
                max_iters: int | None = None,
                with_stats: bool = False) -> jnp.ndarray:
    """Shade a batch of camera rays to radiance [N, 3].

    ``with_stats=True`` returns ``(radiance, net_rays)`` where net_rays is
    the scalar int32 count of rays LIVE lanes actually traced (extension
    rays of active lanes + shadow rays of shaded lanes per light) — the
    survivor-weighted "net" number next to the device-throughput "gross"
    lanes x depth x (1+lights) accounting of bench.py.

    ``differentiable=True`` (default) runs the lane machine as a
    static-trip-count ``fori_loop`` — reverse-mode differentiable, with the
    body checkpointed so the backward pass rematerializes instead of saving
    every iteration's wavefront. ``max_iters=None`` uses the worst-case
    bound, exact for the scene class: D+1 iterations when no dielectric
    exists (ray trees are chains), else the binary-split bound 2^(D+1)
    (capped) — exponential, so differentiable callers should instead pass
    the measured bound from :func:`forward_iteration_count` (+ margin).
    Extra iterations are no-ops (all lanes idle), so every trip count >= the
    true one produces identical images; ``differentiable=False`` keeps the
    early-exit ``while_loop`` for forward-only rendering (CLI, goldens,
    bench) and ignores ``max_iters``.
    """
    final = _render_machine(scene, rays, bg_radiance, key, differentiable,
                            max_iters, with_stats)
    if with_stats:
        return final.radiance.to_array(), final.net
    return final.radiance.to_array()


def forward_iteration_count(scene: T.Scene, rays: intersect.Rays,
                            bg_radiance, key: jax.Array) -> int:
    """Measured iteration count of the forward lane machine (host int).

    Runs the early-exit ``while_loop`` once and reports how many iterations
    it actually took — the deepest lane's ray-tree size, typically ~2D+1 on
    dielectric scenes vs the worst-case 2^(D+1) bound. Call this OUTSIDE any
    jit/grad trace, then pass ``measured + margin`` as ``max_iters`` to the
    differentiable render: the ray-tree topology is piecewise-constant in
    the continuous scene parameters, so the measured trip stays valid under
    the infinitesimal perturbations gradients (and FD checks) probe.
    """
    return int(_iter_count_jit(scene, rays, bg_radiance, key))


@jax.jit
def _iter_count_jit(scene, rays, bg_radiance, key):
    # module-level jit: a fresh ``jax.jit(lambda ...)`` per call would miss
    # the cache every time (function identity keys it) and recompile the
    # whole forward machine — measured as most of the train-step tests'
    # runtime.
    return _render_machine(scene, rays, bg_radiance, key, False, None).it


def _render_machine(scene: T.Scene, rays: intersect.Rays,
                    bg_radiance, key: jax.Array,
                    differentiable: bool, max_iters: int | None,
                    with_stats: bool = False) -> _State:
    # host (numpy) scene leaves cannot be indexed by traced lane ids
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    if not isinstance(bg_radiance, Vec3):
        bg_radiance = Vec3.from_array(jnp.asarray(bg_radiance))
    N = rays.o.shape[0]
    D = max(scene.max_depth, 1)
    mats = scene.materials
    vertex_normals = intersect.compute_vertex_normals(scene)

    state = _State(
        it=jnp.int32(0),
        net=jnp.int32(0),
        active=jnp.ones((N,), bool),
        is_primary=jnp.ones((N,), bool),
        o=rays.o, d=rays.d, time=rays.time,
        thru=Vec3.ones((N,)),
        depth=jnp.full((N,), scene.max_depth, jnp.int32),
        sigma=Vec3.zeros((N,)),
        radiance=Vec3.zeros((N,)),
        sp=jnp.zeros((N,), jnp.int32),
        st_o=Vec3.zeros((D, N)), st_d=Vec3.zeros((D, N)),
        st_thru=Vec3.zeros((D, N)),
        st_depth=jnp.zeros((D, N), jnp.int32),
        st_sigma=Vec3.zeros((D, N)),
    )

    # Upper bound on iterations = max nodes of a depth-D binary split tree
    # when dielectrics can split a lane; a plain chain otherwise. The
    # early-exit while_loop (differentiable=False) always uses this
    # worst-case bound — a caller-passed max_iters only trims the
    # fori_loop path, never truncates a forward render.
    if scene.any_dielectric:
        worst = min(2 ** (scene.max_depth + 1), 1024)
    else:
        worst = scene.max_depth + 1
    if max_iters is None or not differentiable:
        max_iters = worst

    def cond(s: _State):
        return (s.it < max_iters) & jnp.any(s.active | (s.sp > 0))

    # Without dielectrics no lane ever splits: the deferred-ray stack and
    # Beer machinery are statically dead (masks all-False) and skipped.
    has_diel = scene.any_dielectric
    # shadow-tracing lights (each traces one occlusion per shaded lane)
    n_shadow_lights = int(scene.lights.point_pos.shape[0]
                          + scene.lights.dir_dir.shape[0]
                          + scene.lights.spot_pos.shape[0]
                          + scene.lights.area_pos.shape[0]) \
        + (1 if scene.env_texture >= 0 else 0)

    def body(s: _State) -> _State:
        # ---- pop deferred rays into idle lanes ----
        if has_diel:
            popping = (~s.active) & (s.sp > 0)
            spi = jnp.maximum(s.sp - 1, 0)

            o = vwhere(popping, _pick_row3(s.st_o, spi, D), s.o)
            d = vwhere(popping, _pick_row3(s.st_d, spi, D), s.d)
            thru = vwhere(popping, _pick_row3(s.st_thru, spi, D), s.thru)
            depth = jnp.where(popping, _pick_row(s.st_depth, spi, D),
                              s.depth)
            sigma = vwhere(popping, _pick_row3(s.st_sigma, spi, D), s.sigma)
            sp = jnp.where(popping, spi, s.sp)
            active = s.active | popping
        else:
            o, d, thru, depth, sigma = s.o, s.d, s.thru, s.depth, s.sigma
            sp, active = s.sp, s.active

        # ---- wavefront trace ----
        # idle lanes still carry their LAST ray and would re-walk the BVH
        # with it every iteration. A zero DIRECTION retires them at kernel
        # entry (whole idle blocks early-exit) and in the jnp fallback,
        # while keeping every quantity finite for reverse mode (a NaN here
        # leaks through 0*NaN partials into parameter gradients).
        zero = Vec3.zeros((N,))
        d_t = vwhere(active, d, zero)
        wrays = intersect.Rays(o=o, d=d_t, time=s.time)
        hit = intersect.trace(scene, wrays)
        hit_valid = hit.valid & active
        det = intersect.hit_details(scene, wrays, hit, vertex_normals)
        det = det._replace(valid=hit_valid)
        tex = apply_textures(scene, det)
        normal = tex.normal

        # Beer attenuation of the segment just resolved (world dirs are unit
        # length so the segment length is t; src/Scene.cpp:110-115,130-133).
        # det.t is the differentiable recompute of hit.t (same bits).
        if has_diel:
            seg_t = jnp.where(hit_valid, det.t, 0.0)
            thru = thru * Vec3(jnp.exp(-sigma.x * seg_t),
                               jnp.exp(-sigma.y * seg_t),
                               jnp.exp(-sigma.z * seg_t))

        # ---- emissions ----
        iter_key = jax.random.fold_in(key, s.it)
        mat_idx = det.mat
        mtype = mats.mtype[mat_idx]

        # background for primary misses
        miss_primary = active & ~hit_valid & s.is_primary
        radiance = s.radiance + vwhere(miss_primary, bg_radiance, 0.0)

        # ReplaceAll short-circuit on primary hits (src/Scene.cpp:232-234)
        replace_all = hit_valid & s.is_primary & (tex.dm == T.DECAL_REPLACE_ALL)
        radiance = radiance + vwhere(replace_all, thru * tex.tex_color, 0.0)

        shading_lane = hit_valid & ~replace_all
        as_normal = shading_lane & ((mtype == T.MAT_NORMAL) | (depth <= 0))
        as_mirror = shading_lane & ~as_normal & (mtype == T.MAT_MIRROR)
        as_conductor = shading_lane & ~as_normal & (mtype == T.MAT_CONDUCTOR)
        as_dielectric = shading_lane & ~as_normal & (mtype == T.MAT_DIELECTRIC)

        entering = vdot(d, normal) < 0
        emits = as_normal | as_mirror | as_conductor | (as_dielectric & entering)

        # net (survivor-weighted) ray accounting: 1 extension ray per
        # ACTIVE lane + 1 shadow ray per shaded lane per shadow light.
        # STATICALLY gated: the per-iteration cross-lane reductions cost
        # ~25% frame time on the rock100k bench, so the timed render path
        # (with_stats=False) compiles without them.
        if with_stats:
            net = (s.net + jnp.sum(active.astype(jnp.int32))
                   + n_shadow_lights * jnp.sum(emits.astype(jnp.int32)))
        else:
            net = s.net

        sp_point = ShadePoint(
            point=det.point, normal=normal, wo=-d, mat=mat_idx,
            dm=tex.dm, tex_color=tex.tex_color, tex_norm=tex.tex_normalizer,
            time=s.time, valid=emits,
        )
        basic = direct_lighting(scene, sp_point, iter_key)
        radiance = radiance + vscrub_nan(vwhere(emits, thru * basic, 0.0))

        # ---- continuation rays ----
        eps = scene.shadow_eps
        wr = vreflect(d, normal)
        if scene.any_rough:
            chi = jax.random.uniform(jax.random.fold_in(iter_key, 7),
                                     (2, N)) - 0.5
            wr = _glossy_perturb(wr, mats.roughness[mat_idx],
                                 mats.is_rough[mat_idx], chi[0], chi[1])
        refl_o = det.point + normal * eps      # src/Scene.cpp:50 (always +n)
        mfac = _mat3_rows(mats.mirror, mat_idx)
        if scene.any_conductor:
            f_cond = _conductor_fresnel(mats.refraction[mat_idx],
                                        mats.absorption_index[mat_idx],
                                        d, normal)
            w_mirror = vwhere(as_conductor, mfac * f_cond, mfac)
        else:
            w_mirror = mfac

        if has_diel:
            # dielectric refraction (src/Scene.cpp:57-117); snell guarded on
            # non-dielectric lanes (their refraction index may be 0 -> 1/0)
            nt = mats.refraction[mat_idx]
            diel = mtype == T.MAT_DIELECTRIC
            nt_s = jnp.where(diel, nt, 1.0)
            no = vwhere(entering, normal, -normal)
            snell = jnp.where(entering, 1.0 / nt_s, nt_s)
            t_dir, tir = _refract(d, no, snell, diel)
            refr_o = det.point - no * eps
            n_t = jnp.where(entering, nt_s, 1.0)
            n_i = jnp.where(entering, 1.0, nt_s)
            fr = _fresnel_dielectric(n_t, n_i, d, t_dir, no)
            fr = jnp.where(tir, 1.0, fr)
            absorb = _mat3_rows(mats.absorption_coef, mat_idx)

            # mirror/conductor continuation
            cont_reflect = (as_mirror | as_conductor
                            | (as_dielectric & ~entering & tir))
            # dielectric-entering continues with refraction
            cont_refract = as_dielectric & (entering | (~entering & ~tir))

            new_o = vwhere(cont_refract, refr_o, refl_o)
            new_d = vwhere(cont_refract, t_dir, wr)
            w_next = vwhere(cont_refract, Vec3(1.0 - fr, 1.0 - fr, 1.0 - fr),
                            vwhere(as_dielectric & tir, Vec3.ones((N,)),
                                   w_mirror))
            sigma_next = vwhere(as_dielectric & entering, absorb,
                                vwhere(as_dielectric & ~entering & tir,
                                       absorb, 0.0))
        else:
            cont_reflect = as_mirror | as_conductor
            cont_refract = jnp.zeros((N,), bool)
            new_o, new_d, w_next, sigma_next = refl_o, wr, w_mirror, sigma

        continues = (cont_reflect | cont_refract)
        # kill lanes whose continuation carries NaN (subtree contributes 0,
        # mirroring NanCheck of src/Scene.cpp:221-228)
        bad = vany_nan(new_d) | vany_nan(new_o) | vany_nan(thru)
        continues = continues & ~bad

        if has_diel:
            # ---- dielectric split: push the reflected branch ----
            pushes = as_dielectric & ~tir & ~bad
            push_thru = thru * fr
            push_sigma = vwhere(~entering, absorb, Vec3.zeros((N,)))
            put = pushes & (sp < D)
            st_o = _put_row3(s.st_o, sp, put, refl_o, D)
            st_d = _put_row3(s.st_d, sp, put, wr, D)
            st_thru = _put_row3(s.st_thru, sp, put, push_thru, D)
            st_depth = _put_row(s.st_depth, sp, put, depth - 1, D)
            st_sigma = _put_row3(s.st_sigma, sp, put, push_sigma, D)
            sp = jnp.where(pushes & (sp < D), sp + 1, sp)
        else:
            st_o, st_d, st_thru = s.st_o, s.st_d, s.st_thru
            st_depth, st_sigma = s.st_depth, s.st_sigma

        thru = thru * vwhere(continues, w_next, 1.0)

        return _State(
            it=s.it + 1,
            net=net,
            active=continues,
            is_primary=s.is_primary & jnp.zeros_like(continues),
            o=vwhere(continues, new_o, o),
            d=vwhere(continues, new_d, d),
            time=s.time,
            thru=thru,
            depth=jnp.where(continues, depth - 1, depth),
            sigma=vwhere(continues, sigma_next, sigma),
            radiance=radiance,
            sp=sp, st_o=st_o, st_d=st_d, st_thru=st_thru,
            st_depth=st_depth, st_sigma=st_sigma,
        )

    if differentiable:
        # KNOWN XLA:CPU LIMIT: differentiating a normal/bump-mapped
        # scene — where the shading normal feeds the continuation ray —
        # makes XLA:CPU's LLVM pipeline explode (>16 GB, >40 min at 2
        # iterations). The GPU compiles it (tests/test_gpu.py runs that
        # gradient against finite differences). lax.scan and
        # optimization_barrier variants were measured strictly worse on
        # CPU for every other gradient, so the plain checkpointed
        # fori_loop stays; CPU tests scope texture-gradient coverage to
        # kd-decal textures (tests/test_grad.py::TestTextureGrads).
        body_ckpt = jax.checkpoint(body)
        final = jax.lax.fori_loop(0, max_iters, lambda i, s: body_ckpt(s),
                                  state)
    else:
        final = jax.lax.while_loop(cond, body, state)
    return final
