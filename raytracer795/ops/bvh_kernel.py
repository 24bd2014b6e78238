"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

The reference's hot loops — recursive BVH walk + per-leaf triangle tests
(src/BVH.cpp:137-210, src/Shape.cpp:113-155) — become one kernel in which
every lane owns one ray and walks the flat skip-link BVH of ops/bvh.py on
its own: hit an inner node -> next node in DFS order; miss, or finish a
leaf -> the node's skip link. A block of ``BLOCK_RAYS`` lanes loops until
its slowest lane is done; lanes never wait on each other's tree position.

Each loop step does two masked phases for every lane:

- lanes with leaf triangles pending test the next ``TRIS_PER_STEP`` of
  them, in leaf order;
- the other live lanes visit their current node (slab test, prune,
  advance).

so a leaf's triangles are tested after its node visit and before the next
node visit, exactly the order of the jnp oracle in ops/intersect.py
(``_tri_bvh_candidates`` / ``_tri_bvh_anyhit``), whose slab and triangle
helpers the kernel calls directly. Semantics are therefore the oracle's:
the d == 0 slab quirk (src/BVH.cpp:212-266), |t| ranking with strict-less
updates (src/BVH.cpp:165-171), the ``entry > best`` prune, NaN and
zero-direction rays dead on arrival (src/Helper.cpp:28-30). Any-hit lanes
retire at their first qualifying hit.

Tables live in device memory, read by per-lane gathers:

- ``nodes_f`` [M, 8] f32: bmin xyz, bmax xyz, 2 pad — one 32-byte record;
- ``nodes_i`` [M, 4] i32: first, count, miss, pad;
- ``tris`` [T, 12] f32: a, e1 = a-b, e2 = a-c, ng = e1 x e2 per triangle,
  rebuilt in-graph from the live vertices so vertex optimisation moves the
  intersected geometry (node bounds stay load-time, as on the jnp path).

Nothing here differentiates: ``trace`` / ``trace_anyhit`` wrap every input
in ``stop_gradient``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from raytracer795.ops import intersect
from raytracer795.utils.vec3 import Vec3, vany_nan

# Rays per program (one per lane) and warps per program. A program loops
# until its slowest lane is done, so small programs waste less on
# divergent walk lengths. Not measured on this card; tuning is open.
BLOCK_RAYS = 32
NUM_WARPS = 1
# Leaf triangles each pending lane tests per loop step.
TRIS_PER_STEP = 4

_BIG = 3.0e38   # plain float: a jnp scalar would be a captured kernel const


def node_tables(bvh) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FlatBVH -> (nodes_f [M, 8] f32, nodes_i [M, 4] i32), in-graph."""
    bmin = jnp.asarray(bvh.bmin, jnp.float32)
    m = bmin.shape[0]
    nodes_f = jnp.concatenate(
        [bmin, jnp.asarray(bvh.bmax, jnp.float32),
         jnp.zeros((m, 2), jnp.float32)], axis=1)
    nodes_i = jnp.stack(
        [jnp.asarray(bvh.first, jnp.int32), jnp.asarray(bvh.count, jnp.int32),
         jnp.asarray(bvh.miss, jnp.int32), jnp.zeros((m,), jnp.int32)],
        axis=1)
    return nodes_f, nodes_i


def tri_table(vertices, tri_vidx) -> jnp.ndarray:
    """Per-triangle records [T, 12] (a, e1, e2, ng) from live vertices —
    the op order of intersect._group_tri_tables, so the bits match."""
    verts = jnp.asarray(vertices)
    tri_vidx = jnp.asarray(tri_vidx)
    a = verts[tri_vidx[:, 0]]
    b = verts[tri_vidx[:, 1]]
    c = verts[tri_vidx[:, 2]]
    e1 = a - b
    e2 = a - c
    ng = jnp.cross(e1, e2)
    return jnp.concatenate([a, e1, e2, ng], axis=1)


def _gather_vec3(ref, idx, col):
    return Vec3(ref[idx, col], ref[idx, col + 1], ref[idx, col + 2])


def _walk_kernel(n_nodes, n_tris, anyhit, eps_ref, ox_ref, oy_ref, oz_ref,
                 dx_ref, dy_ref, dz_ref, cap_ref, nf_ref, ni_ref, tri_ref,
                 *out_refs):
    int_eps = eps_ref[0]
    o = Vec3(ox_ref[...], oy_ref[...], oz_ref[...])
    d = Vec3(dx_ref[...], dy_ref[...], dz_ref[...])
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)   # inf where d == 0
    t_cap = cap_ref[...]
    dead = (vany_nan(o) | vany_nan(d)
            | ((d.x == 0.0) & (d.y == 0.0) & (d.z == 0.0)))
    zero_i = jnp.zeros(o.x.shape, jnp.int32)
    node0 = jnp.where(dead, n_nodes, zero_i)

    def live(s):
        node, cur, end = s[:3]
        return (node < n_nodes) | (cur < end)

    def cond(s):
        # jnp.any has no Triton lowering (reduce_or); max over int32 does
        return jnp.max(live(s).astype(jnp.int32)) > 0

    def body(s):
        node, cur, end, best_key, best_t, best_idx = s
        # -- leaf phase: next TRIS_PER_STEP pending triangles, in order --
        pending = cur < end
        for u in range(TRIS_PER_STEP):
            p = cur + u
            pi = jnp.clip(p, 0, n_tris - 1)
            ok, t = intersect._tri_test(
                o, d, _gather_vec3(tri_ref, pi, 0),
                _gather_vec3(tri_ref, pi, 3), _gather_vec3(tri_ref, pi, 6),
                _gather_vec3(tri_ref, pi, 9), int_eps)
            ok = ok & pending & (p < end)
            if anyhit:
                best_key = jnp.where(ok & (t > 0) & (t < t_cap),
                                     0.0, best_key)
            else:
                key = jnp.where(ok, jnp.abs(t), _BIG)
                upd = key < best_key
                best_t = jnp.where(upd, t, best_t)
                best_idx = jnp.where(upd, pi, best_idx)
                best_key = jnp.minimum(best_key, key)
        cur = jnp.where(pending, cur + TRIS_PER_STEP, cur)

        # -- node phase: lanes with no pending triangles visit a node --
        visit = ~pending & (node < n_nodes)
        ni = jnp.clip(node, 0, n_nodes - 1)
        box_hit, entry = intersect._slab_test(
            o, d, inv_d, _gather_vec3(nf_ref, ni, 0),
            _gather_vec3(nf_ref, ni, 3))
        bound = t_cap if anyhit else best_key
        box_hit = box_hit & ~(entry > bound)
        first = ni_ref[ni, 0]
        cnt = ni_ref[ni, 1]
        miss = ni_ref[ni, 2]
        is_leaf = cnt > 0
        take = visit & box_hit & is_leaf
        cur = jnp.where(take, first, cur)
        end = jnp.where(take, first + cnt, end)
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, miss)
        node = jnp.where(visit, nxt, node)
        if anyhit:
            # retire at the first qualifying hit
            found = best_key == 0.0
            node = jnp.where(found, n_nodes, node)
            end = jnp.where(found, cur, end)
        return node, cur, end, best_key, best_t, best_idx

    init = (node0, zero_i, zero_i, jnp.full(o.x.shape, _BIG, jnp.float32),
            jnp.zeros(o.x.shape, jnp.float32), zero_i)
    _, _, _, best_key, best_t, best_idx = jax.lax.while_loop(cond, body, init)
    if anyhit:
        out_refs[0][...] = (best_key == 0.0).astype(jnp.int32)
    else:
        key_ref, t_ref, idx_ref = out_refs
        key_ref[...] = best_key
        t_ref[...] = best_t
        idx_ref[...] = best_idx


@functools.partial(jax.jit, static_argnames=("anyhit", "interpret"))
def _walk_call(o, d, t_cap, nodes_f, nodes_i, tris, int_eps, *, anyhit,
               interpret):
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n_nodes, n_tris = nodes_f.shape[0], tris.shape[0]
    n = o.x.shape[0]
    pad = (-n) % BLOCK_RAYS

    def lanes(x, fill):
        x = jnp.asarray(x, jnp.float32)
        return jnp.concatenate([x, jnp.full((pad,), fill, jnp.float32)]) \
            if pad else x

    # padded lanes carry NaN rays: dead on arrival
    rays = [lanes(c, jnp.nan) for c in (*o, *d)]
    cap = lanes(t_cap, 0.0)
    n_pad = n + pad
    eps = jnp.asarray(int_eps, jnp.float32).reshape(1)

    lane = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    whole = pl.BlockSpec()
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    out_shape = [i32] if anyhit else [f32, f32, i32]
    outs = pl.pallas_call(
        functools.partial(_walk_kernel, n_nodes, n_tris, anyhit),
        out_shape=out_shape,
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[whole] + [lane] * 7 + [whole] * 3,
        out_specs=[lane] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_anyhit" if anyhit else "bvh_nearest",
    )(eps, *rays, cap, nodes_f, nodes_i, tris)
    return [x[:n] for x in outs]


def tri_bvh_nearest(bvh, tris, local_o: Vec3, local_d: Vec3, int_eps,
                    interpret: bool = False):
    """Nearest-hit query: (|t| key, t, leaf-order prim index), [N] each —
    the return contract of intersect._tri_bvh_candidates. ``tris`` is the
    tri_table of the BVH's leaf-ordered triangles."""
    nodes_f, nodes_i = node_tables(bvh)
    zeros = jnp.zeros(local_o.x.shape, jnp.float32)
    key, t, idx = _walk_call(local_o, local_d, zeros, nodes_f, nodes_i, tris,
                             int_eps, anyhit=False, interpret=interpret)
    return key, t, idx


def tri_bvh_anyhit(bvh, tris, local_o: Vec3, local_d: Vec3, t_cap, int_eps,
                   interpret: bool = False) -> jnp.ndarray:
    """Occlusion query: any accepted triangle with t in (0, t_cap)? [N]."""
    nodes_f, nodes_i = node_tables(bvh)
    t_cap = jnp.broadcast_to(jnp.asarray(t_cap, jnp.float32),
                             local_o.x.shape)
    (found,) = _walk_call(local_o, local_d, t_cap, nodes_f, nodes_i, tris,
                          int_eps, anyhit=True, interpret=interpret)
    return found != 0
