"""Tests that run on the GPU.

The default suite pins JAX to CPU (conftest), where these tests skip. They
need the compiled traversal kernel on a card and are selected with:

    RT795_GPU_TESTS=1 python -m pytest tests -m gpu -q

They validate what CPU interpret-mode parity cannot: the compiled kernel
against reference goldens (rock100k, instances_rock, and rock1800k as one
1.8M-triangle BVH), the vertex gradient through the kernel path against the
jnp walk on the same card, and the bump-texture gradient whose backward
graph XLA:CPU cannot compile (see models/whitted.py).
"""

import os
import re

import numpy as np
import pytest

import conftest

pytestmark = pytest.mark.gpu


def _render_ldr(loaded):
    from raytracer795 import render as render_mod

    return render_mod.render_camera(loaded, 0, seed=0,
                                    ldr=True).astype(np.float32)


def test_golden_rock100k():
    """Dragon-scale golden: 101k-triangle smooth mesh + mirror floor vs the
    compiled reference renderer (pages/Page2.md:57 analogue)."""
    loaded = conftest.load("rock100k")
    assert loaded.scene.groups[0].bvh is not None
    frac = (np.abs(_render_ldr(loaded) - conftest.golden("rock100k"))
            > 1).mean()
    assert frac < 1e-4, f"{frac:.6f} of LDR pixels differ"


def test_golden_rock1800k_single_bvh():
    """1,800,900 triangles in ONE flat BVH, walked by the kernel, vs the
    compiled reference renderer (the pages/Page2.md:57 dragon scale)."""
    import sys

    sys.path.insert(0, conftest.SCENES)
    import make_assets

    make_assets.ensure_rock(
        os.path.join(conftest.SCENES, "rock1800k.ply"), 1350, 668)
    loaded = conftest.load("rock1800k")
    big = [g for g in loaded.scene.groups if g.n_tris > 1_000_000][0]
    assert big.bvh is not None
    frac = (np.abs(_render_ldr(loaded) - conftest.golden("rock1800k"))
            > 1).mean()
    assert frac < 1e-4, f"{frac:.6f} of LDR pixels differ"


def test_golden_instances_rock():
    """Instance-heavy dispatch (36 MeshInstances + base sharing one BVH,
    batched into single traversal launches) vs the compiled reference
    renderer. Bounds are the transforms/instances golden class (knife-edge
    silhouette pixels under rotated float32 transforms)."""
    from raytracer795.ops import intersect

    loaded = conftest.load("instances_rock")
    clusters = intersect._bvh_clusters(loaded.scene)
    assert clusters and max(len(g) for g in clusters.values()) == 37
    diff = np.abs(_render_ldr(loaded) - conftest.golden("instances_rock"))
    assert diff.mean() < 0.2, f"mean {diff.mean()}"
    assert (diff > 2).mean() < 0.01, f"frac>2 {(diff > 2).mean()}"


def test_train_step_on_pack_backed_mesh():
    """Vertex optimization THROUGH the kernel path: a mesh scene whose
    trace group has a BVH, a toy inverse-rendering loss on the vertices,
    and three checks — the kernel-path gradient matches the jnp-walk
    gradient (RT795_PALLAS=0, same card), SGD on vertices descends, and
    the moved geometry really flows through the kernel's live triangle
    table (the gradient is nonzero)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from raytracer795.models import whitted
    from raytracer795.models.camera import primary_rays
    from raytracer795.scene.loader import load_scene

    loaded = load_scene(os.path.join(conftest.SCENES, "ply_smooth.xml"),
                        bvh_min_tris=1)
    scene = loaded.scene
    assert any(g.bvh is not None for g in scene.groups), \
        "scene must exercise the kernel path"
    cam = dc.replace(loaded.cameras[0], nx=24, ny=24, num_samples=1, grid=1)
    rays = primary_rays(cam)
    n = rays.o.shape[0]
    bg = jnp.broadcast_to(jnp.asarray(scene.background), (n, 3))
    key = jax.random.PRNGKey(0)
    iters = whitted.forward_iteration_count(scene, rays, bg, key) + 1
    v0 = jnp.asarray(scene.vertices)

    img0 = whitted.render_rays(scene, rays, bg, key, max_iters=iters)
    target = 0.9 * img0

    def loss_of(verts):
        sc = dc.replace(scene, vertices=verts)
        img = whitted.render_rays(sc, rays, bg, key, max_iters=iters)
        return jnp.mean((img - target) ** 2)

    # kernel path (default on the GPU)
    os.environ["RT795_PALLAS"] = "1"
    g_kernel = np.asarray(jax.jit(jax.grad(loss_of))(v0))
    # jnp-walk path: same card, kernel disabled; separate closure so the
    # jit cache cannot reuse the kernel-path trace
    os.environ["RT795_PALLAS"] = "0"
    try:
        g_oracle = np.asarray(jax.jit(
            jax.grad(lambda v: loss_of(v) * 1.0))(v0))
    finally:
        os.environ.pop("RT795_PALLAS", None)

    assert np.isfinite(g_kernel).all() and np.isfinite(g_oracle).all()
    assert np.abs(g_kernel).max() > 0, "vertex gradient identically zero"
    scale = np.abs(g_oracle).max() + 1e-12
    np.testing.assert_allclose(g_kernel, g_oracle, rtol=2e-3,
                               atol=2e-3 * scale)

    # SGD on vertices through the kernel path must descend
    grad_jit = jax.jit(jax.grad(loss_of))
    loss_jit = jax.jit(loss_of)
    v = v0
    losses = []
    for _ in range(3):
        losses.append(float(loss_jit(v)))
        v = v - 2e-4 * grad_jit(v)
    assert np.isfinite(np.asarray(v)).all()
    assert float(loss_jit(v)) < losses[0], losses


def test_normal_bump_texture_grad_fd(tmp_path):
    """Gradient of the rendered image w.r.t. a BUMP texture's texels,
    validated by central finite differences ON THE CARD.

    The bump image feeds the shading normal which feeds the continuation
    rays; XLA:CPU cannot compile this backward graph (models/whitted.py
    comment), so this is the only place it is exercised. The scene is
    textures.xml with its JPEG swapped for the lossless PNG copy of the
    same pixels, so no JPEG decoder is needed.
    """
    import dataclasses as dc

    import jax
    import jax.numpy as jnp

    from raytracer795.models import whitted
    from raytracer795.models.camera import primary_rays
    from raytracer795.scene import types as T
    from raytracer795.scene.loader import load_scene

    text = open(os.path.join(conftest.SCENES, "textures.xml")).read()
    text = re.sub(r"(<Image id=\"\d+\">)([^<]+)(</Image>)",
                  lambda m: m.group(1) + os.path.join(
                      conftest.SCENES, m.group(2).strip().replace(
                          ".jpg", ".png")) + m.group(3), text)
    assert ".jpg" not in text
    xml = tmp_path / "textures_png.xml"
    xml.write_text(text)
    loaded = load_scene(str(xml))
    scene = loaded.scene

    cam = dc.replace(loaded.cameras[0], nx=24, ny=24, num_samples=1, grid=1)
    rays = primary_rays(cam)
    n = rays.o.shape[0]
    bg = jnp.broadcast_to(scene.background, (n, 3))
    key = jax.random.PRNGKey(0)
    iters = whitted.forward_iteration_count(scene, rays, bg, key) + 1

    # texture index with bump_normal decal (textures.xml: bump.png)
    bump_ti = next(i for i, st in enumerate(scene.texture_statics)
                   if st[0] == T.DECAL_BUMP_NORMAL)
    im0 = jnp.asarray(scene.textures[bump_ti].image)

    def loss_img(im):
        texs = list(scene.textures)
        texs[bump_ti] = dc.replace(texs[bump_ti], image=im)
        sc = dc.replace(scene, textures=tuple(texs))
        return jnp.mean(whitted.render_rays(sc, rays, bg, key,
                                            max_iters=iters))

    loss_jit = jax.jit(loss_img)
    g = np.asarray(jax.jit(jax.grad(loss_img))(im0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "bump texture gradient is identically zero"

    # central FD at the two strongest texels (texel values are 0..255;
    # bump height is piecewise-linear in them via the forward-difference
    # sampling contract, but the normalize() downstream is mildly
    # nonlinear -> 5% tolerance)
    flat = np.abs(g).ravel()
    for k in np.argsort(flat)[-2:]:
        y, x, c = np.unravel_index(k, g.shape)
        eps = 2.0
        lp = float(loss_jit(im0.at[y, x, c].add(eps)))
        lm = float(loss_jit(im0.at[y, x, c].add(-eps)))
        fd = (lp - lm) / (2 * eps)
        assert abs(g[y, x, c] - fd) <= 0.05 * max(abs(fd), 1e-12), \
            (int(y), int(x), int(c), g[y, x, c], fd)
