"""Wavefront intersection: ray batches vs the scene's trace groups.

The reference's hot path (src/Helper.cpp:18-80 world dispatch →
src/BVH.cpp:112-210 per-object BVH → src/Shape.cpp:113-155,347-398 primitive
tests) becomes a two-phase vectorized pass per group:

phase 1 (``trace``): t-only candidates for every (ray, primitive) pair,
    reduced to the per-group and then global nearest hit. Groups with a
    flat BVH walk it: on the GPU through the per-ray traversal kernel
    (ops/bvh_kernel.py), elsewhere through the jnp lockstep walk below,
    which is also the kernel's reference.
phase 2 (``hit_details``): geometric attributes (point, normal, bary, uv
    inputs) recomputed only for each ray's single winning primitive.

LAYOUT: everything per-lane is component-SoA (``Vec3`` = three [N] arrays,
utils/vec3.py). All reductions keep the x, y, z order of the [N, 3]
formulation, so results are bit-identical.

Semantics preserved from the reference:
- triangle test accepts t >= -int_eps, beta/gamma >= -int_eps,
  beta+gamma <= 1 (src/Shape.cpp:146-147);
- sphere test requires discriminant >= int_eps (src/Shape.cpp:355-356) and
  picks among the t1/t2 sign cases (src/Shape.cpp:365-388);
- within an object the nearest hit is chosen by |local point - origin|
  (src/BVH.cpp:165-171), i.e. by |t|; across objects world t must be > 0
  (src/Helper.cpp:43);
- rays containing NaN match nothing (src/Helper.cpp:28-30) — all comparisons
  with NaN are False, so this falls out naturally;
- transformed groups intersect in local space via M^-1 with the motion-blur
  offset ``origin -= blur * time`` applied first (src/Helper.cpp:110-133);
  the local-space ray is intentionally NOT renormalized so t is a shared
  world/local parameter (src/Ray.cpp:21-40 gett recovers exactly this t).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer795.scene import types as T
from raytracer795.utils.vec3 import (Mat3, Vec3, const_affine_apply,
                                     const_mat3_apply, mwhere, vany_nan,
                                     vcross, vdot, vmasked_normalize,
                                     vwhere)

# Plain float, NOT jnp.float32: a module-level device array would
# initialize the XLA backend at import time, which breaks multi-process
# launchers that must call jax.distributed.initialize() first.
_BIG = 3.0e38

# Primitive-chunk size for the non-unrolled t-pass: bounds [N, CHUNK] temps.
_PRIM_CHUNK = 512


def _traversal_mode():
    """BVH traversal dispatch: 'on' (GPU kernel), 'off' (jnp walk), or
    'interp' (the kernel in the Pallas interpreter).

    The per-ray kernel (ops/bvh_kernel.py) is the trace path on the GPU;
    the jnp lockstep ``while_loop`` is the CPU path and the kernel's
    reference. RT795_PALLAS=0 selects the jnp walk on any backend;
    RT795_PALLAS=interp runs the kernel interpreted, which only the CPU
    allows. No backend falls back silently.
    """
    import os

    flag = os.environ.get("RT795_PALLAS", "1")
    backend = jax.default_backend()
    if flag == "0":
        return "off"
    if flag == "interp":
        if backend != "cpu":
            raise RuntimeError("RT795_PALLAS=interp runs only on the CPU "
                               f"backend, not {backend!r}")
        return "interp"
    if backend == "gpu":
        return "on"
    if backend == "cpu":
        return "off"
    raise RuntimeError(f"no BVH traversal path for backend {backend!r}")


class Rays(NamedTuple):
    o: Vec3             # [N] x3
    d: Vec3             # [N] x3
    time: jnp.ndarray   # [N]


class Hit(NamedTuple):
    valid: jnp.ndarray      # [N] bool
    t: jnp.ndarray          # [N] world-space ray parameter
    group: jnp.ndarray      # [N] int32 index into scene.groups
    prim: jnp.ndarray       # [N] int32 index within the group's prim kind
    is_sphere: jnp.ndarray  # [N] bool


class HitDetails(NamedTuple):
    valid: jnp.ndarray
    point: Vec3             # world
    normal: Vec3            # LOCAL-space normal, normalized. Texture normal
    #                         math runs in local space (the reference textures
    #                         inside the BVH step, pre-transform); the world
    #                         transform by (M^-1)^T is applied once after
    #                         texturing (src/Helper.cpp:75-78).
    mat: jnp.ndarray        # [N] int32
    t: jnp.ndarray          # [N]
    tex0: jnp.ndarray       # [N] int32 (-1 none)
    tex1: jnp.ndarray       # [N] int32
    u: jnp.ndarray          # [N] texture coordinates (tri bary / sphere)
    v: jnp.ndarray          # [N]
    # sphere-local quantities for texture TBN math (src/Shape.cpp:400-472)
    local_point: Vec3       # hit point in group-local space
    local_center: Vec3      # sphere center (local) or zeros
    radius: jnp.ndarray     # [N]
    # triangle quantities for TBN math (src/Shape.cpp:505-616)
    tri_e1: Vec3            # b - a (local)
    tri_e2: Vec3            # c - a (local)
    uv0u: jnp.ndarray       # [N] corner texture coordinates
    uv0v: jnp.ndarray
    uv1u: jnp.ndarray
    uv1v: jnp.ndarray
    uv2u: jnp.ndarray
    uv2v: jnp.ndarray
    is_sphere: jnp.ndarray  # [N] bool
    minv_t: Mat3            # normal transform (rows) of the hit group
    emission: Vec3          # object-light radiance of the hit prim


def _transform_rays(group: T.TraceGroup, rays: Rays) -> Rays:
    """World ray -> group-local ray (src/Helper.cpp:110-133)."""
    if not group.has_xform and not group.has_blur:
        return rays
    blur = group.blur
    if group.has_blur:
        o = Vec3(rays.o.x - blur[0] * rays.time,
                 rays.o.y - blur[1] * rays.time,
                 rays.o.z - blur[2] * rays.time)
    else:
        o = rays.o
    if group.has_xform:
        m = group.minv
        o = const_affine_apply(m, o)
        d = const_mat3_apply(m, rays.d)
    else:
        d = rays.d
    return Rays(o=o, d=d, time=rays.time)


def _bbox_pass(group: T.TraceGroup, local: Rays) -> jnp.ndarray:
    """Slab test of each source object's root bbox: [N, O+1] bool.

    Exact semantics of BVH::RayBBoxIntersection (src/BVH.cpp:212-266): per
    axis, entry/exit picked by the sign of d (d == 0 falls into the negative
    branch, producing +/-inf and rejecting the box — a reference quirk kept);
    hit iff min(exits) >= max(entries). Column O is an always-true slot for
    exempt primitives (single-leaf BVHs are never bbox-tested). Unrolled per
    object with flat [N] math; O is small (it counts source objects).
    """
    n_obj = group.obj_bbox.shape[0]
    N = local.o.shape[0]
    if n_obj == 0:
        return jnp.ones((N, 1), bool)
    o, d = local.o, local.d
    cols = []
    for oi in range(n_obj):
        bmin = group.obj_bbox[oi, 0]
        bmax = group.obj_bbox[oi, 1]
        entry = jnp.full((N,), -jnp.inf)
        exit_ = jnp.full((N,), jnp.inf)
        for ox, dx, lo, hi in ((o.x, d.x, bmin[0], bmax[0]),
                               (o.y, d.y, bmin[1], bmax[1]),
                               (o.z, d.z, bmin[2], bmax[2])):
            pos = dx > 0
            t_e = jnp.where(pos, (lo - ox) / dx, (hi - ox) / dx)
            t_l = jnp.where(pos, (hi - ox) / dx, (lo - ox) / dx)
            entry = jnp.maximum(entry, t_e)
            exit_ = jnp.minimum(exit_, t_l)
        cols.append(~(exit_ < entry))
    cols.append(jnp.ones((N,), bool))
    return jnp.stack(cols, axis=-1)


# Below this many primitives, the brute sweep unrolls a per-primitive Python
# loop of flat [N] ops; larger prim counts chunk into [N, C] sweeps.
_UNROLL_PRIMS = 96


def _group_tri_tables(scene: T.Scene, group: T.TraceGroup):
    """Per-triangle component tables [T]: a, e1=a-b, e2=a-c, n_geo=e1xe2.

    One-time [T]-sized work per compiled program (XLA hoists it out of any
    lane loops); matches the reference's column setup (src/Shape.cpp:120-132).
    """
    verts = jnp.asarray(scene.vertices)
    a = verts[jnp.asarray(group.tri_vidx)[:, 0]]    # [T, 3]
    b = verts[group.tri_vidx[:, 1]]
    c = verts[group.tri_vidx[:, 2]]
    e1 = a - b                          # reference column a-b
    e2 = a - c
    ng = jnp.cross(e1, e2)
    av = Vec3.from_array(a)
    e1v = Vec3.from_array(e1)
    e2v = Vec3.from_array(e2)
    ngv = Vec3.from_array(ng)
    return av, e1v, e2v, ngv


def _tri_test(o: Vec3, d: Vec3, a: Vec3, e1: Vec3, e2: Vec3, ng: Vec3,
              int_eps):
    """Cramer solve of src/Shape.cpp:120-132 on [N] component arrays.

    Returns (accept mask, t). Inputs a/e1/e2/ng may be per-lane gathers or
    scalar broadcasts.
    """
    ao = a - o
    e2xd = vcross(e2, d)
    det = vdot(e1, e2xd)
    inv_det = 1.0 / det
    beta = vdot(ao, e2xd) * inv_det
    e1xd = vcross(e1, d)
    gamma = -vdot(ao, e1xd) * inv_det
    t = vdot(ng, ao) * inv_det
    ok = ((t >= -int_eps) & (beta >= -int_eps) & (gamma >= -int_eps)
          & (beta + gamma <= 1.0))
    return ok, t


def _tri_candidates_unrolled(scene: T.Scene, group: T.TraceGroup, local: Rays,
                             bbox_ok: jnp.ndarray):
    """Per-prim unrolled nearest-triangle sweep (small groups, lane-shaped).

    Same math and accept/ranking semantics as the chunked sweep — Cramer
    solve of src/Shape.cpp:120-132 with the |t| ranking of
    src/BVH.cpp:165-171 — but every intermediate is [N], so XLA emits
    flat elementwise code with no primitive-axis padding.
    """
    av, e1v, e2v, ngv = _group_tri_tables(scene, group)
    int_eps = scene.int_eps
    o, d = local.o, local.d
    N = o.shape[0]

    best_key = jnp.full((N,), _BIG)
    best_t = jnp.zeros((N,))
    best_idx = jnp.zeros((N,), jnp.int32)
    n_obj = bbox_ok.shape[1] - 1

    for ti in range(group.n_tris):
        a = Vec3(av.x[ti], av.y[ti], av.z[ti])      # static scalar slices
        e1 = Vec3(e1v.x[ti], e1v.y[ti], e1v.z[ti])
        e2 = Vec3(e2v.x[ti], e2v.y[ti], e2v.z[ti])
        ng = Vec3(ngv.x[ti], ngv.y[ti], ngv.z[ti])
        ok, t = _tri_test(o, d, a, e1, e2, ng, int_eps)
        obj = jnp.where(group.tri_obj[ti] < 0, n_obj, group.tri_obj[ti])
        ok = ok & jnp.take(bbox_ok, obj, axis=1)
        key = jnp.where(ok, jnp.abs(t), _BIG)
        upd = key < best_key
        best_t = jnp.where(upd, t, best_t)
        best_idx = jnp.where(upd, ti, best_idx)
        best_key = jnp.minimum(best_key, key)

    return best_key, best_t, best_idx


def _tri_candidates(scene: T.Scene, group: T.TraceGroup, local: Rays,
                    bbox_ok: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest triangle per ray: (|t|-ranked best t, prim index).

    Chunked sweep: [N, C] component arrays (C <= 512 spans the lane axis
    cleanly) — no [N, C, 3] temporaries.
    """
    if group.n_tris <= _UNROLL_PRIMS:
        return _tri_candidates_unrolled(scene, group, local, bbox_ok)
    av, e1v, e2v, ngv = _group_tri_tables(scene, group)
    n_tris = group.n_tris
    int_eps = scene.int_eps

    o, d = local.o, local.d
    N = o.shape[0]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]   # [N, 1]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    best_key = jnp.full((N,), _BIG)
    best_t = jnp.zeros((N,))
    best_idx = jnp.zeros((N,), jnp.int32)
    n_obj = bbox_ok.shape[1] - 1

    for start in range(0, n_tris, _PRIM_CHUNK):
        end = min(start + _PRIM_CHUNK, n_tris)
        sl = slice(start, end)
        a = Vec3(av.x[sl][None, :], av.y[sl][None, :], av.z[sl][None, :])
        e1 = Vec3(e1v.x[sl][None, :], e1v.y[sl][None, :], e1v.z[sl][None, :])
        e2 = Vec3(e2v.x[sl][None, :], e2v.y[sl][None, :], e2v.z[sl][None, :])
        ng = Vec3(ngv.x[sl][None, :], ngv.y[sl][None, :], ngv.z[sl][None, :])
        ob = Vec3(ox, oy, oz)
        db = Vec3(dx, dy, dz)
        ok, t = _tri_test(ob, db, a, e1, e2, ng, int_eps)      # [N, C]
        obj = jnp.where(group.tri_obj[sl] < 0, n_obj, group.tri_obj[sl])
        ok = ok & bbox_ok[:, obj]
        key = jnp.where(ok, jnp.abs(t), _BIG)
        ci = jnp.argmin(key, axis=-1)                           # [N]
        ckey = jnp.take_along_axis(key, ci[:, None], axis=-1)[:, 0]
        ct = jnp.take_along_axis(t, ci[:, None], axis=-1)[:, 0]
        upd = ckey < best_key
        best_t = jnp.where(upd, ct, best_t)
        best_idx = jnp.where(upd, ci.astype(jnp.int32) + start, best_idx)
        best_key = jnp.minimum(best_key, ckey)

    return best_key, best_t, best_idx


def _sphere_test(o: Vec3, d: Vec3, cx, cy, cz, r, int_eps):
    """Quadratic of src/Shape.cpp:347-388 on component arrays."""
    ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
    dd = d.x * d.x + d.y * d.y + d.z * d.z
    b = d.x * ocx + d.y * ocy + d.z * ocz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - dd * cq
    ok = disc >= int_eps
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b + sq) / dd
    t2 = (-b - sq) / dd
    # sign cases (src/Shape.cpp:365-388)
    t = jnp.where((t1 >= 0) & (t2 < 0), t1,
                  jnp.where((t2 >= 0) & (t1 < 0), t2, jnp.minimum(t1, t2)))
    ok = ok & ~((t1 < 0) & (t2 < 0))
    return ok, t


def _sphere_candidates(scene: T.Scene, group: T.TraceGroup, local: Rays
                       ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest sphere per ray (quadratic, src/Shape.cpp:347-388)."""
    centers = scene.vertices[group.sph_cidx]        # [S, 3]
    radii = group.sph_radius
    int_eps = scene.int_eps
    o, d = local.o, local.d
    N = o.shape[0]

    if group.n_spheres <= _UNROLL_PRIMS:
        best_key = jnp.full((N,), _BIG)
        best_t = jnp.zeros((N,))
        best_idx = jnp.zeros((N,), jnp.int32)
        for si in range(group.n_spheres):
            ok, t = _sphere_test(o, d, centers[si, 0], centers[si, 1],
                                 centers[si, 2], radii[si], int_eps)
            key = jnp.where(ok, jnp.abs(t), _BIG)
            upd = key < best_key
            best_t = jnp.where(upd, t, best_t)
            best_idx = jnp.where(upd, si, best_idx)
            best_key = jnp.minimum(best_key, key)
        return best_key, best_t, best_idx

    ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    ok, t = _sphere_test(ob, db, centers[None, :, 0], centers[None, :, 1],
                         centers[None, :, 2], radii[None, :], int_eps)
    key = jnp.where(ok, jnp.abs(t), _BIG)
    si = jnp.argmin(key, axis=-1)
    skey = jnp.take_along_axis(key, si[:, None], axis=-1)[:, 0]
    st = jnp.take_along_axis(t, si[:, None], axis=-1)[:, 0]
    return skey, st, si.astype(jnp.int32)


def _bvh_tables(group: T.TraceGroup):
    """Component tables of a group's flat BVH."""
    bvh: T.FlatBVH = jax.tree_util.tree_map(jnp.asarray, group.bvh)
    bmin = Vec3.from_array(bvh.bmin)        # [M] x3
    bmax = Vec3.from_array(bvh.bmax)
    return bvh, bmin, bmax


def _gather3(tbl: Vec3, idx) -> Vec3:
    return Vec3(tbl.x[idx], tbl.y[idx], tbl.z[idx])


def _slab_test(o: Vec3, d: Vec3, inv_d: Vec3, bmin: Vec3, bmax: Vec3):
    """Reference slab test (src/BVH.cpp:212-266) on per-lane boxes.

    d == 0 lanes produce +/-inf via inv_d and reject the box — quirk kept.
    Returns (box_hit, entry distance).
    """
    entry = jnp.full_like(o.x, -jnp.inf)
    exit_ = jnp.full_like(o.x, jnp.inf)
    for ox, dx, ix, lo, hi in ((o.x, d.x, inv_d.x, bmin.x, bmax.x),
                               (o.y, d.y, inv_d.y, bmin.y, bmax.y),
                               (o.z, d.z, inv_d.z, bmin.z, bmax.z)):
        pos = dx > 0
        t_e = jnp.where(pos, (lo - ox) * ix, (hi - ox) * ix)
        t_l = jnp.where(pos, (hi - ox) * ix, (lo - ox) * ix)
        entry = jnp.maximum(entry, t_e)
        exit_ = jnp.minimum(exit_, t_l)
    return ~(exit_ < entry), entry


def _tri_bvh_candidates(scene: T.Scene, group: T.TraceGroup, local: Rays
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest triangle per ray via the group's flat BVH.

    Stackless skip-link walk (see ops/bvh.py): every lane advances through
    the DFS node order — hit an inner node -> next node; miss, or finish a
    leaf's primitive block -> the node's skip link. All lanes run in lockstep
    inside one ``lax.while_loop``; finished lanes idle at node == n_nodes.

    Semantics match the brute-force `_tri_candidates` path exactly:
    - the slab test keeps the reference quirk that a zero direction component
      rejects the box via inf/NaN arithmetic (src/BVH.cpp:212-266), and boxes
      fully behind the origin still traverse (no exit >= 0 test);
    - pruning skips a node only when its entry distance exceeds the current
      best |t| and the entry is ahead of the origin — exactly the hits the
      |t| ranking (src/BVH.cpp:165-171) could still accept;
    - triangle accept tests and |t| ranking as in src/Shape.cpp:113-155.
    """
    bvh, bmin_t, bmax_t = _bvh_tables(group)
    n_nodes = bvh.bmin.shape[0]
    n_tris = group.n_tris
    K = bvh.max_leaf
    int_eps = scene.int_eps
    av, e1v, e2v, ngv = _group_tri_tables(scene, group)

    o, d = local.o, local.d
    N = o.shape[0]
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)   # inf where d == 0

    # Lanes that can never hit (NaN ray or all-zero direction) start done:
    # they'd otherwise accept every bbox through NaN comparisons and walk the
    # whole tree (the brute path rejects them per-prim, src/Helper.cpp:28-30).
    dead = (vany_nan(o) | vany_nan(d)
            | ((d.x == 0.0) & (d.y == 0.0) & (d.z == 0.0)))
    node0 = jnp.where(dead, n_nodes, 0).astype(jnp.int32)

    def cond(state):
        node = state[0]
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_key, best_t, best_idx = state
        active = node < n_nodes
        ni = jnp.minimum(node, n_nodes - 1)
        box_hit, entry = _slab_test(o, d, inv_d, _gather3(bmin_t, ni),
                                    _gather3(bmax_t, ni))
        box_hit = box_hit & ~(entry > best_key)        # safe |t| prune
        cnt = bvh.count[ni]
        is_leaf = cnt > 0
        first = bvh.first[ni]

        do_leaf = active & box_hit & is_leaf
        for j in range(K):
            pi = jnp.clip(first + j, 0, n_tris - 1)
            ok_j = do_leaf & (j < cnt)
            ok, t = _tri_test(o, d, _gather3(av, pi), _gather3(e1v, pi),
                              _gather3(e2v, pi), _gather3(ngv, pi), int_eps)
            ok = ok & ok_j
            key = jnp.where(ok, jnp.abs(t), _BIG)
            upd = key < best_key
            best_t = jnp.where(upd, t, best_t)
            best_idx = jnp.where(upd, pi.astype(jnp.int32), best_idx)
            best_key = jnp.minimum(best_key, key)

        nxt = jnp.where(box_hit & ~is_leaf, node + 1, bvh.miss[ni])
        node = jnp.where(active, nxt, node).astype(jnp.int32)
        return node, best_key, best_t, best_idx

    state = (node0, jnp.full((N,), _BIG), jnp.zeros((N,)),
             jnp.zeros((N,), jnp.int32))
    _, best_key, best_t, best_idx = jax.lax.while_loop(cond, body, state)
    return best_key, best_t, best_idx


def _bvh_clusters(scene: T.Scene):
    """Group indices sharing one flat BVH (instances of a base mesh, loader
    ``bvh_share`` ids), batched into one walk each.
    RT795_BATCH_INSTANCES=0 disables batching (A/B switch)."""
    import os

    if os.environ.get("RT795_BATCH_INSTANCES", "1") == "0":
        return {}
    clusters = {}
    for gi, group in enumerate(scene.groups):
        if group.bvh is not None and group.bvh_share >= 0:
            clusters.setdefault(group.bvh_share, []).append(gi)
    return {s: gis for s, gis in clusters.items() if len(gis) > 1}


def _concat_local_rays(scene: T.Scene, gis, rays: Rays):
    """Per-group local rays stacked on the lane axis: [G*N] components."""
    locs = [_transform_rays(scene.groups[gi], rays) for gi in gis]
    o = Vec3(*(jnp.concatenate([getattr(l.o, c) for l in locs])
               for c in "xyz"))
    d = Vec3(*(jnp.concatenate([getattr(l.d, c) for l in locs])
               for c in "xyz"))
    return o, d


def _walk_nearest(scene: T.Scene, group: T.TraceGroup, o: Vec3, d: Vec3,
                  mode):
    """Nearest hit through the group's BVH: kernel or jnp walk."""
    if mode == "off":
        return _tri_bvh_candidates(scene, group, Rays(o=o, d=d, time=None))
    from raytracer795.ops import bvh_kernel

    return bvh_kernel.tri_bvh_nearest(
        group.bvh, bvh_kernel.tri_table(scene.vertices, group.tri_vidx), o,
        d, scene.int_eps, interpret=(mode == "interp"))


def _walk_anyhit(scene: T.Scene, group: T.TraceGroup, o: Vec3, d: Vec3,
                 t_cap, mode):
    """Occlusion through the group's BVH: kernel or jnp walk."""
    if mode == "off":
        return _tri_bvh_anyhit(scene, group, Rays(o=o, d=d, time=None),
                               t_cap)
    from raytracer795.ops import bvh_kernel

    return bvh_kernel.tri_bvh_anyhit(
        group.bvh, bvh_kernel.tri_table(scene.vertices, group.tri_vidx), o,
        d, t_cap, scene.int_eps, interpret=(mode == "interp"))


def _batched_nearest(scene: T.Scene, gis, rays: Rays, mode):
    """ONE traversal walk for all instances sharing a BVH.

    The reference's world dispatch walks instances sequentially
    (src/Helper.cpp:53-73); a per-group launch here costs a fixed kernel
    dispatch each — G instances x (1+lights) x depth launches per frame.
    Batching transforms the wavefront into every instance's local space,
    concatenates the lanes, and walks the shared tables once (on the jnp
    path: one lockstep loop instead of G). Per-lane results are
    bit-identical to per-group walks (lane math does not depend on its
    neighbours). Returns [G, N] (key, t, prim).
    """
    N = rays.o.shape[0]
    o, d = _concat_local_rays(scene, gis, rays)
    k, t, i = _walk_nearest(scene, scene.groups[gis[0]], o, d, mode)
    G = len(gis)
    return k.reshape(G, N), t.reshape(G, N), i.reshape(G, N)


def _batched_anyhit(scene: T.Scene, gis, rays: Rays, t_cap, mode):
    """Occlusion analogue of _batched_nearest: [G, N] found."""
    N = rays.o.shape[0]
    o, d = _concat_local_rays(scene, gis, rays)
    G = len(gis)
    f = _walk_anyhit(scene, scene.groups[gis[0]], o, d, jnp.tile(t_cap, G),
                     mode)
    return f.reshape(G, N)


def trace(scene: T.Scene, rays: Rays) -> Hit:
    """Nearest hit over all groups (world dispatch, src/Helper.cpp:18-80).

    The whole query is wrapped in ``stop_gradient``: which primitive a ray
    hits is a discrete decision (piecewise-constant in every parameter), and
    the candidate sweep divides/sqrt-s over ALL primitives — garbage on the
    non-winning ones — which poisons reverse-mode AD. ``hit_details``
    recomputes the winner's t (and every other geometric quantity)
    differentiably, so gradients flow through the implicit hit point exactly
    as SURVEY phase 8 prescribes, and the BVH walk's ``lax.while_loop``
    never appears on the AD tape at all.
    """
    sg = jax.lax.stop_gradient
    scene = jax.tree_util.tree_map(sg, scene)
    rays = jax.tree_util.tree_map(sg, rays)
    N = rays.o.shape[0]
    best_t = jnp.full((N,), _BIG)
    best_group = jnp.zeros((N,), jnp.int32)
    best_prim = jnp.zeros((N,), jnp.int32)
    best_sph = jnp.zeros((N,), bool)
    valid = jnp.zeros((N,), bool)

    mode = _traversal_mode()
    batched = {}
    for gis in _bvh_clusters(scene).values():
        bk, bt, bi = _batched_nearest(scene, gis, rays, mode)
        for slot, gi in enumerate(gis):
            batched[gi] = (bk[slot], bt[slot], bi[slot])

    for gi, group in enumerate(scene.groups):
        local = _transform_rays(group, rays)
        g_key = jnp.full((N,), _BIG)
        g_t = jnp.zeros((N,))
        g_prim = jnp.zeros((N,), jnp.int32)
        g_sph = jnp.zeros((N,), bool)
        if group.n_tris:
            if gi in batched:
                tk, tt, tidx = batched[gi]
            elif group.bvh is not None:
                tk, tt, tidx = _walk_nearest(scene, group, local.o, local.d,
                                             mode)
            else:
                bbox_ok = _bbox_pass(group, local)
                tk, tt, tidx = _tri_candidates(scene, group, local, bbox_ok)
            g_key, g_t, g_prim = tk, tt, tidx
        if group.n_spheres:
            sk, st, sidx = _sphere_candidates(scene, group, local)
            upd = sk < g_key
            g_t = jnp.where(upd, st, g_t)
            g_prim = jnp.where(upd, sidx, g_prim)
            g_sph = upd | (group.n_tris == 0)
            g_key = jnp.minimum(g_key, sk)
        # world-level accept: t > 0 and nearer (src/Helper.cpp:43)
        ok = (g_key < _BIG) & (g_t > 0) & (g_t < best_t)
        best_t = jnp.where(ok, g_t, best_t)
        best_group = jnp.where(ok, gi, best_group)
        best_prim = jnp.where(ok, g_prim, best_prim)
        best_sph = jnp.where(ok, g_sph, best_sph)
        valid = valid | ok

    return Hit(valid=valid, t=best_t, group=best_group, prim=best_prim,
               is_sphere=best_sph)


def _tri_bvh_anyhit(scene: T.Scene, group: T.TraceGroup, local: Rays,
                    t_cap: jnp.ndarray) -> jnp.ndarray:
    """Any accepted triangle with t in (0, t_cap)? Early-exit BVH walk.

    Same skip-link lockstep walk as ``_tri_bvh_candidates`` with two shadow
    optimizations: nodes whose entry distance exceeds t_cap are pruned, and
    a lane retires the moment it finds any qualifying hit (the reference
    runs full nearest-hit for shadows, src/Light.cpp:188-204 — an any-hit
    needs none of that bookkeeping).
    """
    bvh, bmin_t, bmax_t = _bvh_tables(group)
    n_nodes = bvh.bmin.shape[0]
    n_tris = group.n_tris
    K = bvh.max_leaf
    int_eps = scene.int_eps
    av, e1v, e2v, ngv = _group_tri_tables(scene, group)

    o, d = local.o, local.d
    N = o.shape[0]
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)

    dead = (vany_nan(o) | vany_nan(d)
            | ((d.x == 0.0) & (d.y == 0.0) & (d.z == 0.0)))
    node0 = jnp.where(dead, n_nodes, 0).astype(jnp.int32)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        node, found = state
        active = node < n_nodes
        ni = jnp.minimum(node, n_nodes - 1)
        box_hit, entry = _slab_test(o, d, inv_d, _gather3(bmin_t, ni),
                                    _gather3(bmax_t, ni))
        box_hit = box_hit & ~(entry > t_cap)
        cnt = bvh.count[ni]
        is_leaf = cnt > 0
        first = bvh.first[ni]

        do_leaf = active & box_hit & is_leaf
        for j in range(K):
            pi = jnp.clip(first + j, 0, n_tris - 1)
            ok_j = do_leaf & (j < cnt)
            ok, t = _tri_test(o, d, _gather3(av, pi), _gather3(e1v, pi),
                              _gather3(e2v, pi), _gather3(ngv, pi), int_eps)
            found = found | (ok & ok_j & (t > 0) & (t < t_cap))

        nxt = jnp.where(box_hit & ~is_leaf, node + 1, bvh.miss[ni])
        nxt = jnp.where(found, n_nodes, nxt)        # early exit
        node = jnp.where(active, nxt, node).astype(jnp.int32)
        return node, found

    _, found = jax.lax.while_loop(cond, body, (node0, jnp.zeros((N,), bool)))
    return found


def trace_anyhit(scene: T.Scene, rays: Rays, t_cap) -> jnp.ndarray:
    """Occlusion query: any primitive with world t in (0, t_cap)? [N] bool.

    Cheaper than ``trace`` for shadows: no |t| ranking, no argmin winner
    bookkeeping, early-exit BVH walk. Semantics deviation (documented): the
    reference shadows via the full nearest-hit dispatch, whose per-object
    |t| ranking can let a *backface at negative t* mask a real positive-t
    occluder (src/BVH.cpp:165-171); the any-hit reports the physically
    correct answer in that corner case. Everything is stop-gradient —
    visibility is discrete.
    """
    sg = jax.lax.stop_gradient
    scene = jax.tree_util.tree_map(sg, scene)
    rays = jax.tree_util.tree_map(sg, rays)
    t_cap = sg(jnp.broadcast_to(jnp.asarray(t_cap, jnp.float32),
                                rays.o.shape[:1]))
    N = rays.o.shape[0]
    found = jnp.zeros((N,), bool)

    mode = _traversal_mode()
    skip = set()
    for gis in _bvh_clusters(scene).values():
        bf = _batched_anyhit(scene, gis, rays, t_cap, mode)
        found = found | jnp.any(bf, axis=0)
        skip.update(gis)

    for gi, group in enumerate(scene.groups):
        local = _transform_rays(group, rays)
        if group.n_tris and gi not in skip:
            if group.bvh is not None:
                found = found | _walk_anyhit(scene, group, local.o, local.d,
                                             t_cap, mode)
            else:
                bbox_ok = _bbox_pass(group, local)
                k, t, _ = _tri_candidates(scene, group, local, bbox_ok)
                found = found | ((k < _BIG) & (t > 0) & (t < t_cap))
        if group.n_spheres:
            k, t, _ = _sphere_candidates(scene, group, local)
            found = found | ((k < _BIG) & (t > 0) & (t < t_cap))

    return found


def compute_vertex_normals(scene: T.Scene) -> jnp.ndarray:
    """Accumulate flat normals of smooth triangles onto vertices.

    Mirrors Scene::renderScene's vertex-normal pass (src/Scene.cpp:302-318,
    src/Shape.cpp:262-276): per smooth triangle add normalize((c-b)x(a-b)) to
    its three vertices, then normalize per vertex. Runs in-graph so vertex
    gradients flow through shading normals. [V, 3] tables are fine — V-sized
    setup work, not per-lane.
    """
    verts = scene.vertices
    acc = jnp.zeros_like(verts)
    for group in scene.groups:
        if not group.n_tris:
            continue
        vidx = group.tri_vidx
        a = verts[vidx[:, 0]]
        b = verts[vidx[:, 1]]
        c = verts[vidx[:, 2]]
        n = jnp.cross(c - b, a - b)
        # safe divisor: a degenerate (zero-area) triangle contributes NaN in
        # the reference too, but its 1/0 would also NaN the *gradients* of
        # every healthy triangle through the scatter-add — guard it.
        sq = jnp.sum(n * n, axis=-1, keepdims=True)
        n = n / jnp.sqrt(jnp.where(sq > 0, sq, 1.0))
        w = (group.tri_smooth & (sq[:, 0] > 0)).astype(verts.dtype)[:, None]
        n = n * w
        for k in range(3):
            acc = acc.at[vidx[:, k]].add(n)
    # vertices used by no smooth triangle (sphere centers!) have acc == 0;
    # jnp.linalg.norm's VJP at 0 is 0/0 — use the squared-sum guard instead.
    sq = jnp.sum(acc * acc, axis=-1, keepdims=True)
    return acc / jnp.sqrt(jnp.where(sq > 0, sq, 1.0))


def hit_details(scene: T.Scene, rays: Rays, hit: Hit,
                vertex_normals: jnp.ndarray) -> HitDetails:
    """Phase 2: full geometric attributes for each ray's winning primitive.

    ONE gather pass regardless of group count: the per-group primitive
    tables are concatenated (under jit — XLA materializes them once per
    compiled program) and every lane gathers its winner through a global id
    ``offset[group] + prim``. Per-group transforms are gathered the same way
    (per-component [G] tables indexed by the winning group), so
    instance-heavy scenes (the reference's metal_glass/instanced scenes,
    src/Helper.cpp:53-73) cost the same as single-object ones — unlike the
    reference's per-object dispatch loop (src/Helper.cpp:18-80).

    This is also the ONLY differentiable geometry path: ``trace`` is
    stop-gradient, and the winner's t / bary / quadratic are recomputed here
    (same op order as the trace, so forward bits are identical) with
    masked-lane guards everywhere a dead lane's garbage would NaN the VJP.
    """
    N = rays.o.shape[0]
    zero = jnp.zeros((N,))
    zeros3 = Vec3(zero, zero, zero)
    # Miss lanes carry t = _BIG whose o + t*d overflows to inf and poisons
    # reverse mode through every downstream op; give them a finite dummy t.
    # Valid lanes are overwritten below with the differentiable recompute.
    t0 = jnp.where(hit.valid, hit.t, 1.0)
    out = HitDetails(
        valid=hit.valid,
        point=rays.o + rays.d * t0,                 # world (Helper.cpp:47)
        normal=zeros3, mat=jnp.zeros((N,), jnp.int32), t=t0,
        tex0=jnp.full((N,), -1, jnp.int32), tex1=jnp.full((N,), -1, jnp.int32),
        u=zero, v=zero, local_point=zeros3, local_center=zeros3,
        radius=zero, tri_e1=zeros3, tri_e2=zeros3,
        uv0u=zero, uv0v=zero, uv1u=zero, uv1v=zero, uv2u=zero, uv2v=zero,
        is_sphere=hit.is_sphere,
        minv_t=Mat3.identity_like((N,)),
        emission=zeros3,
    )

    verts = jnp.asarray(scene.vertices)
    groups = [jax.tree_util.tree_map(jnp.asarray, g) for g in scene.groups]
    if not groups:
        return out
    g = hit.group

    # ---- per-lane local ray via gathered group transforms ----
    # Flattened [G, 16/9/3] tables, ONE row gather each, then column
    # slices — instead of 24 mixed advanced+scalar indexings
    # (``minv[g, 0, 0]``), each its own scalar-offset gather.
    # Fully static scenes (no transforms, no blur — the common case) skip
    # the gathers and matrix math entirely: local == world, minv_t == I.
    static_world = all(not gr.has_xform and not gr.has_blur
                       for gr in groups)
    if static_world:
        local_o, local_d = rays.o, rays.d
        lane_minv_t = out.minv_t        # identity
    else:
        minv = jnp.stack([gr.minv.reshape(16) for gr in groups])    # [G, 16]
        minv_t3 = jnp.stack([gr.minv_t[:3, :3].reshape(9) for gr in groups])
        blur = jnp.stack([gr.blur for gr in groups])                # [G, 3]
        mrec = minv[g]          # [N, 16]
        trec = minv_t3[g]       # [N, 9]
        brec = blur[g]          # [N, 3]
        o_b = Vec3(rays.o.x - brec[:, 0] * rays.time,
                   rays.o.y - brec[:, 1] * rays.time,
                   rays.o.z - brec[:, 2] * rays.time)

        def lane_mat3(rec, stride):
            return Mat3(
                Vec3(rec[:, 0], rec[:, 1], rec[:, 2]),
                Vec3(rec[:, stride], rec[:, stride + 1], rec[:, stride + 2]),
                Vec3(rec[:, 2 * stride], rec[:, 2 * stride + 1],
                     rec[:, 2 * stride + 2]))

        mv3 = lane_mat3(mrec, 4)
        local_o = mv3.apply(o_b) + Vec3(mrec[:, 3], mrec[:, 7], mrec[:, 11])
        local_d = mv3.apply(rays.d)
        lane_minv_t = lane_mat3(trec, 3)

    # host-side global-id offsets from static per-group counts
    tri_offs = np.cumsum([0] + [gr.n_tris for gr in groups])
    sph_offs = np.cumsum([0] + [gr.n_spheres for gr in groups])
    n_tris_total = int(tri_offs[-1])
    n_sph_total = int(sph_offs[-1])

    def concat(field, kinds):
        arrs = [getattr(gr, field) for gr, n in kinds if n]
        return jnp.concatenate(arrs, axis=0)

    tri_kinds = [(gr, gr.n_tris) for gr in groups]
    sph_kinds = [(gr, gr.n_spheres) for gr in groups]

    if n_tris_total:
        sel = hit.valid & ~hit.is_sphere
        tid = jnp.clip(jnp.asarray(tri_offs, jnp.int32)[g] + hit.prim,
                       0, n_tris_total - 1)
        # ---- per-TRIANGLE attribute table, gathered by ONE [N]-row pass ----
        # Instead of ~33 separate per-lane gathers (vertices x3, normals
        # x3, uv x6, mat/tex/smooth/emis...), the table below is
        # [T]-sized work (XLA hoists it out of any lane math, and its own
        # gathers are over the small primitive axis); the per-lane part
        # collapses to one row gather of a [T, 32]-wide record. Gradients
        # to scene.vertices / texcoords / vertex_normals flow through the
        # table construction's gathers (scatter-add VJP), unchanged.
        vidx_t = concat("tri_vidx", tri_kinds)              # [T, 3]
        i0t, i1t, i2t = vidx_t[:, 0], vidx_t[:, 1], vidx_t[:, 2]
        uvoff_t = concat("tri_uvoff", tri_kinds)
        texcoords = jnp.asarray(scene.texcoords)
        ntc = texcoords.shape[0]
        j0t = jnp.clip(i0t + uvoff_t, 0, ntc - 1)
        j1t = jnp.clip(i1t + uvoff_t, 0, ntc - 1)
        j2t = jnp.clip(i2t + uvoff_t, 0, ntc - 1)
        col = lambda x: x.astype(jnp.float32)[:, None]
        table = jnp.concatenate([
            verts[i0t], verts[i1t], verts[i2t],             # a b c   0:9
            vertex_normals[i0t], vertex_normals[i1t],
            vertex_normals[i2t],                            # n0..n2  9:18
            texcoords[j0t], texcoords[j1t], texcoords[j2t],  # uv     18:24
            concat("tri_emis", tri_kinds),                  # emis   24:27
            col(concat("tri_smooth", tri_kinds)),           # 27
            col(concat("tri_mat", tri_kinds)),              # 28 (ids exact
            col(concat("tri_tex0", tri_kinds)),             # 29  in f32:
            col(concat("tri_tex1", tri_kinds)),             # 30  < 2^24)
        ], axis=1)
        rec = table[tid]                                    # [N, 31]
        v3 = lambda k: Vec3(rec[:, k], rec[:, k + 1], rec[:, k + 2])
        a, b, c = v3(0), v3(3), v3(6)
        # Recompute bary AND t for the winner (the same Cramer system the
        # trace solved, src/Shape.cpp:120-132) — this is where gradients
        # flow. Same op order as _tri_candidates: identical forward bits.
        e1, e2 = a - b, a - c
        e2xd = vcross(e2, local_d)
        det = vdot(e1, e2xd)
        # masked-lane hygiene: dead lanes gather a clipped garbage primitive
        # whose det may be 0; 1/0 there NaNs the backward pass even under
        # jnp.where. Winners always have det != 0.
        inv_det = 1.0 / jnp.where(det != 0, det, 1.0)
        ao = a - local_o
        beta = vdot(ao, e2xd) * inv_det
        e1xd = vcross(e1, local_d)
        gamma = -vdot(ao, e1xd) * inv_det
        t_tri = vdot(vcross(e1, e2), ao) * inv_det
        alpha = 1.0 - beta - gamma
        lpoint = local_o + local_d * t_tri
        smooth = rec[:, 27] != 0
        n_flat = vcross(c - b, a - b)
        n_smooth = v3(9) * alpha + v3(12) * beta + v3(15) * gamma
        n = vwhere(smooth, n_smooth, n_flat)
        n = vmasked_normalize(sel, n)
        u0, v0 = rec[:, 18], rec[:, 19]
        u1, v1 = rec[:, 20], rec[:, 21]
        u2, v2 = rec[:, 22], rec[:, 23]
        uu = u0 * alpha + u1 * beta + u2 * gamma
        vv = v0 * alpha + v1 * beta + v2 * gamma
        out = out._replace(
            point=vwhere(sel, rays.o + rays.d * t_tri, out.point),
            t=jnp.where(sel, t_tri, out.t),
            normal=vwhere(sel, n, out.normal),
            mat=jnp.where(sel, rec[:, 28].astype(jnp.int32), out.mat),
            tex0=jnp.where(sel, rec[:, 29].astype(jnp.int32), out.tex0),
            tex1=jnp.where(sel, rec[:, 30].astype(jnp.int32), out.tex1),
            u=jnp.where(sel, uu, out.u),
            v=jnp.where(sel, vv, out.v),
            local_point=vwhere(sel, lpoint, out.local_point),
            tri_e1=vwhere(sel, b - a, out.tri_e1),
            tri_e2=vwhere(sel, c - a, out.tri_e2),
            uv0u=jnp.where(sel, u0, out.uv0u),
            uv0v=jnp.where(sel, v0, out.uv0v),
            uv1u=jnp.where(sel, u1, out.uv1u),
            uv1v=jnp.where(sel, v1, out.uv1v),
            uv2u=jnp.where(sel, u2, out.uv2u),
            uv2v=jnp.where(sel, v2, out.uv2v),
            minv_t=mwhere(sel, lane_minv_t, out.minv_t),
            emission=vwhere(sel, v3(24), out.emission),
        )

    if n_sph_total:
        sel = hit.valid & hit.is_sphere
        sid = jnp.clip(jnp.asarray(sph_offs, jnp.int32)[g] + hit.prim,
                       0, n_sph_total - 1)
        vt = Vec3.from_array(verts)
        center = _gather3(vt, concat("sph_cidx", sph_kinds)[sid])
        radius = concat("sph_radius", sph_kinds)[sid]
        # recompute the winner's t (quadratic of src/Shape.cpp:347-388,
        # same op order as _sphere_candidates) so center/radius/ray grads
        # flow through the implicit hit point.
        oc = local_o - center
        dd = vdot(local_d, local_d)
        bq = vdot(local_d, oc)
        cq = vdot(oc, oc) - radius * radius
        disc = bq * bq - dd * cq
        # winners have disc >= int_eps > 0 and dd > 0; guard dead lanes
        sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0)) * (disc > 0)
        inv_dd = 1.0 / jnp.where(dd != 0, dd, 1.0)
        t1 = (-bq + sq) * inv_dd
        t2 = (-bq - sq) * inv_dd
        t_sph = jnp.where((t1 >= 0) & (t2 < 0), t1,
                          jnp.where((t2 >= 0) & (t1 < 0), t2,
                                    jnp.minimum(t1, t2)))
        lpoint = local_o + local_d * t_sph
        lc = lpoint - center
        n = vmasked_normalize(sel, lc)      # local-space normal
        # sphere UV from local spherical coords (src/Shape.cpp:413-417);
        # double-where on the arccos input: dead lanes clip to +/-1 where
        # arccos' derivative is infinite.
        cos_theta = jnp.clip(lc.y / jnp.where(radius > 0, radius, 1.0),
                             -1.0, 1.0)
        theta = jnp.arccos(jnp.where(sel, cos_theta, 0.0))
        phi = jnp.arctan2(lc.z, jnp.where(sel, lc.x, 1.0))
        uu = (-phi + jnp.pi) / (2.0 * jnp.pi)
        vv = theta / jnp.pi
        emis = Vec3.from_array(concat("sph_emis", sph_kinds))
        out = out._replace(
            point=vwhere(sel, rays.o + rays.d * t_sph, out.point),
            t=jnp.where(sel, t_sph, out.t),
            normal=vwhere(sel, n, out.normal),
            mat=jnp.where(sel, concat("sph_mat", sph_kinds)[sid], out.mat),
            tex0=jnp.where(sel, concat("sph_tex0", sph_kinds)[sid], out.tex0),
            tex1=jnp.where(sel, concat("sph_tex1", sph_kinds)[sid], out.tex1),
            u=jnp.where(sel, uu, out.u),
            v=jnp.where(sel, vv, out.v),
            local_point=vwhere(sel, lpoint, out.local_point),
            local_center=vwhere(sel, center, out.local_center),
            radius=jnp.where(sel, radius, out.radius),
            minv_t=mwhere(sel, lane_minv_t, out.minv_t),
            emission=vwhere(sel, _gather3(emis, sid), out.emission),
        )

    return out
