"""Traversal-kernel parity: the GPU kernel vs the jnp reference walk.

The per-ray traversal kernel (ops/bvh_kernel.py) is the trace path on the
GPU; the jnp lockstep while_loop (ops/intersect.py) is its reference. On the
CPU test mesh the kernel runs in the Pallas interpreter — same program,
exact arithmetic — so bit-parity here proves the kernel logic; the kernel is
also lowered for CUDA here, which proves the Triton route accepts it. The
compiled artifact is proven on the card (tests/test_gpu.py).
"""

import os

import numpy as np
import pytest

import conftest


def _random_mesh(t, seed):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    return verts, tri_vidx


def _random_rays(n, seed):
    import jax.numpy as jnp

    from raytracer795.utils.vec3 import Vec3

    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # slab-quirk + dead-lane coverage
    d[: n // 16, 1] = 0.0
    o[n // 16: n // 8] = np.nan
    d[n // 8: 3 * n // 16] = 0.0
    return (Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))


class _Scene:
    """The two scene fields the traversal reads."""

    def __init__(self, verts, int_eps):
        import jax.numpy as jnp

        self.vertices = jnp.asarray(verts)
        self.int_eps = int_eps


class _Group:
    """The group fields the traversal reads."""

    def __init__(self, flat, tv):
        import jax
        import jax.numpy as jnp

        self.bvh = jax.tree_util.tree_map(jnp.asarray, flat)
        self.tri_vidx = jnp.asarray(tv)
        self.n_tris = int(tv.shape[0])


def _bvh_mesh(t, seed):
    from raytracer795.ops import bvh as bvh_mod

    verts, tri_vidx = _random_mesh(t, seed)
    flat, perm = bvh_mod.build(*bvh_mod.tri_bounds(verts, tri_vidx))
    return verts, flat, tri_vidx[perm]


def _kernel(scene, group, o, d, cap=None):
    """Interpreted kernel: nearest (key, t, idx) or any-hit found."""
    from raytracer795.ops import bvh_kernel

    tris = bvh_kernel.tri_table(scene.vertices, group.tri_vidx)
    if cap is None:
        return tuple(map(np.asarray, bvh_kernel.tri_bvh_nearest(
            group.bvh, tris, o, d, scene.int_eps, interpret=True)))
    return np.asarray(bvh_kernel.tri_bvh_anyhit(
        group.bvh, tris, o, d, cap, scene.int_eps, interpret=True))


def _oracle(scene, group, o, d, cap=None):
    import jax
    import jax.numpy as jnp

    from raytracer795.ops import intersect

    rays = intersect.Rays(o=o, d=d, time=jnp.zeros(o.x.shape))
    if cap is None:
        return tuple(map(np.asarray, jax.jit(
            lambda r: intersect._tri_bvh_candidates(scene, group, r))(rays)))
    return np.asarray(jax.jit(
        lambda r: intersect._tri_bvh_anyhit(scene, group, r, cap))(rays))


def _assert_nearest_parity(got, want):
    key, tt, idx = got
    rk, rt, ridx = want
    hit_p, hit_r = key < 1e38, rk < 1e38
    np.testing.assert_array_equal(hit_p, hit_r)
    both = hit_p & hit_r
    np.testing.assert_array_equal(idx[both], ridx[both])
    # t compare: the oracle's XLA fusion reassociates a couple ulp under
    # --xla_backend_optimization_level=0 (conftest); masks/ids stay exact
    np.testing.assert_allclose(tt[both], rt[both], rtol=2e-5, atol=2e-5)
    return hit_p


@pytest.mark.parametrize("t,n,seed", [(333, 1500, 0), (2048, 4096, 1)])
def test_kernel_parity_random_mesh(t, n, seed):
    import jax.numpy as jnp

    verts, flat, tv = _bvh_mesh(t, seed)
    scene, group = _Scene(verts, jnp.float32(1e-3)), _Group(flat, tv)
    o, d = _random_rays(n, seed + 10)

    hit = _assert_nearest_parity(_kernel(scene, group, o, d),
                                 _oracle(scene, group, o, d))
    assert hit.any()

    # anyhit parity, including the per-lane t_cap
    cap = jnp.asarray(
        np.random.default_rng(seed + 20).uniform(0.1, 5.0, n), jnp.float32)
    np.testing.assert_array_equal(_kernel(scene, group, o, d, cap),
                                  _oracle(scene, group, o, d, cap))


def test_pack_prim_ids_cover_all_triangles():
    """The kernel tables cover the mesh: leaf ranges partition the
    triangles exactly once, node records carry the FlatBVH fields, and
    triangle records are (a, a-b, a-c, (a-b)x(a-c)) of the live vertices."""
    from raytracer795.ops import bvh_kernel

    verts, flat, tv = _bvh_mesh(777, 3)
    nodes_f, nodes_i = map(np.asarray, bvh_kernel.node_tables(flat))
    assert nodes_f.shape == (flat.first.shape[0], 8)
    np.testing.assert_array_equal(nodes_f[:, 0:3], flat.bmin)
    np.testing.assert_array_equal(nodes_f[:, 3:6], flat.bmax)
    np.testing.assert_array_equal(nodes_i[:, 0], flat.first)
    np.testing.assert_array_equal(nodes_i[:, 1], flat.count)
    np.testing.assert_array_equal(nodes_i[:, 2], flat.miss)
    leaves = nodes_i[:, 1] > 0
    seen = np.concatenate([np.arange(f, f + c) for f, c
                           in nodes_i[leaves, :2]])
    assert np.sort(seen).tolist() == list(range(777))
    assert nodes_i[:, 1].max() <= flat.max_leaf

    tris = np.asarray(bvh_kernel.tri_table(verts, tv))
    a, b, c = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    np.testing.assert_array_equal(tris[:, 0:3], a)
    np.testing.assert_array_equal(tris[:, 3:6], a - b)
    np.testing.assert_array_equal(tris[:, 6:9], a - c)
    np.testing.assert_allclose(tris[:, 9:12], np.cross(a - b, a - c),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,n,seed", [(600, 1024, 2)])
def test_multipack_parity_random_mesh(t, n, seed, tmp_path):
    """A group above the former 120k-triangle split point loads as ONE
    flat BVH (no partition into packs), and the kernel walks it with
    oracle parity."""
    import sys

    import jax.numpy as jnp

    from raytracer795.render import scene_stats
    from raytracer795.scene.loader import load_scene
    from raytracer795.utils.vec3 import Vec3

    sys.path.insert(0, conftest.SCENES)
    import make_assets

    nu, nv = 404, 151                       # 2 * nu * (nv - 1) triangles
    make_assets.make_rock_ply(str(tmp_path / "big.ply"), nu=nu, nv=nv)
    xml = tmp_path / "big.xml"
    xml.write_text(
        "<Scene><Cameras><Camera id=\"1\"><Position>0 0 3</Position>"
        "<Gaze>0 0 -1</Gaze><Up>0 1 0</Up><NearPlane>-1 1 -1 1</NearPlane>"
        "<NearDistance>1</NearDistance><ImageResolution>8 8"
        "</ImageResolution><ImageName>big.png</ImageName></Camera>"
        "</Cameras><Materials><Material id=\"1\"/></Materials><Objects>"
        "<Mesh id=\"1\"><Material>1</Material><Faces plyFile=\"big.ply\"/>"
        "</Mesh></Objects></Scene>")
    loaded = load_scene(str(xml))
    (group,) = loaded.scene.groups
    assert group.n_tris == 2 * nu * (nv - 1) > 120_000
    assert group.bvh is not None
    assert not hasattr(group, "bvh_pack") and not hasattr(group, "pack_bvhs")
    counts = np.asarray(group.bvh.count)
    assert counts.sum() == group.n_tris
    assert scene_stats(loaded.scene)["bvh_nodes"] == counts.shape[0]

    # n rays from in front of the rock, aimed at it
    rng = np.random.default_rng(seed + t)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    o[:, 2] = 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d[:, 2] = -1.0
    o, d = Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d))
    scene = _Scene(loaded.scene.vertices, loaded.scene.int_eps)
    hit = _assert_nearest_parity(_kernel(scene, group, o, d),
                                 _oracle(scene, group, o, d))
    assert hit.mean() > 0.5


def test_kernel_parity_perturbed_vertices():
    """Vertex-optimization closure: move the vertices AFTER the BVH is
    built, rebuild the kernel triangle table in-graph from the live
    vertices (what intersect does inside trace), and assert the kernel
    still bit-matches the jnp oracle evaluated on the SAME live vertices.
    Both paths keep the stale load-time BVH boxes, so parity must hold for
    any step size."""
    import jax.numpy as jnp

    t, n, seed = 333, 1024, 5
    verts, flat, tv = _bvh_mesh(t, seed)
    o, d = _random_rays(n, seed + 10)
    int_eps = jnp.float32(1e-3)

    # an optimizer step: every vertex moves
    rng = np.random.default_rng(seed + 1)
    verts2 = verts + rng.normal(scale=0.05, size=verts.shape).astype(
        np.float32)

    group = _Group(flat, tv)
    moved = _Scene(verts2, int_eps)
    got = _kernel(moved, group, o, d)
    hit = _assert_nearest_parity(got, _oracle(moved, group, o, d))
    assert hit.any()
    # sanity: the move really changed the answer vs the load-time vertices
    k0, _, _ = _kernel(_Scene(verts, int_eps), group, o, d)
    assert not np.array_equal(k0, got[0])


def test_batched_instance_dispatch_bitwise():
    """Groups sharing one BVH (instances of one base mesh) are batched
    into ONE traversal walk (ops/intersect.py BVH clusters), on the kernel
    and on the jnp path; results must be bit-identical to the per-group
    loop."""
    import jax
    import jax.numpy as jnp

    from raytracer795.models import camera as camera_model
    from raytracer795.ops import intersect
    from raytracer795.scene.loader import load_scene

    # bvh_min_tris=1 gives even the 6-triangle base mesh a BVH, so the two
    # MeshInstances + base form a 3-group shared-BVH cluster
    loaded = load_scene(os.path.join(conftest.SCENES, "instances.xml"),
                        bvh_min_tris=1)
    scene = loaded.scene
    assert len(intersect._bvh_clusters(scene)) >= 1
    import dataclasses as dc

    cam = dc.replace(loaded.cameras[0], nx=32, ny=32, num_samples=1, grid=1)
    rays = camera_model.primary_rays(cam)

    def run():
        # fresh closures: the traversal choice is read at trace time
        hit = jax.jit(lambda s, r: intersect.trace(s, r))(scene, rays)
        found = jax.jit(lambda s, r: intersect.trace_anyhit(
            s, r, jnp.full(r.o.shape[:1], 4.0)))(scene, rays)
        return hit, found

    for mode in ("interp", "0"):
        os.environ["RT795_PALLAS"] = mode
        try:
            os.environ["RT795_BATCH_INSTANCES"] = "0"
            h_u, f_u = run()
            os.environ["RT795_BATCH_INSTANCES"] = "1"
            h_b, f_b = run()
        finally:
            os.environ.pop("RT795_PALLAS", None)
            os.environ.pop("RT795_BATCH_INSTANCES", None)

        assert bool(np.asarray(h_b.valid).any())
        for a, b in zip(h_u, h_b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(f_u), np.asarray(f_b))


def test_kernel_parity_axis_aligned_vertex_origins():
    """The d == 0 NaN-entry corner: rays with a zero direction component
    whose origin coordinates sit EXACTLY on vertex/bbox-bound coordinates.
    Each lane walks its own path, so the kernel must stay bit-equal to the
    per-lane oracle walk here."""
    import jax.numpy as jnp

    from raytracer795.utils.vec3 import Vec3

    t, seed = 222, 7
    verts, flat, tv = _bvh_mesh(t, seed)
    scene, group = _Scene(verts, jnp.float32(1e-3)), _Group(flat, tv)

    # axis-aligned rays: origin coordinates copied EXACTLY from node-box
    # bounds and vertex coordinates; one direction component zeroed
    rng = np.random.default_rng(seed + 1)
    bounds = np.concatenate([np.asarray(flat.bmin), np.asarray(flat.bmax),
                             verts]).astype(np.float32)
    n = 1280
    pick = rng.integers(0, bounds.shape[0], (n, 3))
    o = bounds[pick, rng.integers(0, 3, (n, 3))]
    d = np.zeros((n, 3), np.float32)
    main_ax = rng.integers(0, 3, n)
    zero_ax = rng.integers(0, 3, n)
    d[np.arange(n), main_ax] = rng.choice([-1.0, 1.0], n)
    # a third of lanes: second nonzero component (diagonal, one zero axis)
    diag = rng.random(n) < 0.33
    other = (main_ax + 1) % 3
    d[diag, other[diag]] = rng.choice([-1.0, 1.0], diag.sum())
    d[np.arange(n), zero_ax] = 0.0

    o_v = Vec3.from_array(jnp.asarray(o))
    d_v = Vec3.from_array(jnp.asarray(d))
    _assert_nearest_parity(_kernel(scene, group, o_v, d_v),
                           _oracle(scene, group, o_v, d_v))
    cap = jnp.full((n,), 3.0)
    np.testing.assert_array_equal(_kernel(scene, group, o_v, d_v, cap),
                                  _oracle(scene, group, o_v, d_v, cap))


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_kernel_lane_padding(n):
    """Lane counts off the program width pad with dead NaN rays and slice
    back: output shapes are [n] and every lane matches the oracle."""
    import jax.numpy as jnp

    verts, flat, tv = _bvh_mesh(64, 11)
    scene, group = _Scene(verts, jnp.float32(1e-3)), _Group(flat, tv)
    o, d = _random_rays(max(n, 16), 12)
    o = type(o)(*(c[:n] for c in o))
    d = type(d)(*(c[:n] for c in d))
    got = _kernel(scene, group, o, d)
    assert [x.shape for x in got] == [(n,)] * 3
    _assert_nearest_parity(got, _oracle(scene, group, o, d))
    found = _kernel(scene, group, o, d, jnp.full((n,), 2.0))
    assert found.shape == (n,) and found.dtype == bool


@pytest.mark.parametrize("flag,backend,want", [
    ("1", "gpu", "on"), ("1", "cpu", "off"), ("0", "gpu", "off"),
    ("interp", "cpu", "interp"), ("interp", "gpu", RuntimeError),
    ("1", "rocm", RuntimeError),
])
def test_traversal_mode_choice(flag, backend, want, monkeypatch):
    """The kernel runs on the GPU, the jnp walk on the CPU, the
    interpreter only where a CPU test asks; nothing gives way silently."""
    import jax

    from raytracer795.ops import intersect

    monkeypatch.setenv("RT795_PALLAS", flag)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is RuntimeError:
        with pytest.raises(RuntimeError):
            intersect._traversal_mode()
    else:
        assert intersect._traversal_mode() == want


@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_lowers_for_cuda(anyhit):
    """The kernel cross-lowers through the Triton route with no card
    present: every primitive it uses has a Triton lowering."""
    import jax
    import jax.numpy as jnp

    from raytracer795.ops import bvh_kernel

    verts, flat, tv = _bvh_mesh(96, 4)
    o, d = _random_rays(256, 5)
    tris = bvh_kernel.tri_table(verts, tv)

    def f(o, d, tris):
        if anyhit:
            return bvh_kernel.tri_bvh_anyhit(flat, tris, o, d, 2.0,
                                             jnp.float32(1e-3))
        return bvh_kernel.tri_bvh_nearest(flat, tris, o, d,
                                          jnp.float32(1e-3))

    text = jax.jit(f).trace(o, d, tris).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
