"""Multi-device SPMD tests on the 8-virtual-device CPU mesh.

SURVEY §4 prescribes fake-mesh multi-device tests as the JAX analogue of a
fake backend: the same SPMD program that runs on a pod runs here on
xla_force_host_platform_device_count=8 CPU devices (tests/conftest.py).
Covers: 1-device vs 8-device forward parity, sharded-vs-unsharded gradient
equality, finite psum'd gradients, and a toy inverse-rendering loss descent
— the exact failure mode of round 1 (finite loss, NaN parameter updates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import load


def _ray_batch(loaded, nx=16, ny=16):
    from raytracer795.models import camera as camera_model

    cam = dataclasses.replace(loaded.cameras[0], nx=nx, ny=ny,
                              num_samples=1, grid=1)
    return camera_model.primary_rays(cam)


@pytest.fixture(scope="module")
def setup():
    loaded = load("cornellbox")       # deterministic Whitted scene
    rays = _ray_batch(loaded)
    n = rays.o.shape[0]
    bg = jnp.broadcast_to(loaded.scene.background, (n, 3)).astype(jnp.float32)
    key = jax.random.PRNGKey(3)
    return loaded.scene, rays, bg, key


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_forward_parity_1_vs_8_devices(setup):
    """The SPMD render must be bit-identical on 1-device and 8-device meshes
    (deterministic scene: the per-chip RNG decorrelation never draws)."""
    from raytracer795.parallel import shard as par

    scene, rays, bg, key = setup
    img1 = par.render_rays_sharded(scene, rays, bg, key, par.make_ray_mesh(1))
    img8 = par.render_rays_sharded(scene, rays, bg, key, par.make_ray_mesh(8))
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img8))


@pytest.mark.slow
def test_sharded_grads_match_unsharded(setup):
    """psum'd data-parallel gradients == single-program jax.grad.

    slow-marked: two full backward compiles (~3 min on this box). The
    default lane still covers sharded gradients via
    test_train_step_decreases_loss_and_stays_finite (finite psum'd grads +
    loss descent on the same program)."""
    from raytracer795.models import whitted
    from raytracer795.parallel import shard as par

    scene, rays, bg, key = setup
    target = jnp.full((rays.o.shape[0], 3), 0.25, jnp.float32)
    mesh = par.make_ray_mesh(8)
    n_total = rays.o.shape[0]

    _, grads, _ = par.train_step_with_grads(scene, rays, bg, target, key,
                                            mesh)

    params = par.differentiable_params(scene)

    iters = par.resolve_whitted_iters(scene, rays, bg, key)

    def loss_fn(p):
        sc = par.scene_with_params(scene, p)
        img = whitted.render_rays(sc, rays, bg,
                                  jax.random.fold_in(key, 0),
                                  max_iters=iters)
        return jnp.sum((img - target) ** 2) / (3.0 * n_total)

    ref_grads = jax.jit(jax.grad(loss_fn))(params)
    for name in ("diffuse", "mirror", "point_intensity", "vertices"):
        g_sh = np.asarray(grads[name])
        g_ref = np.asarray(ref_grads[name])
        assert np.isfinite(g_sh).all(), name
        # tolerance scaled to the gradient's magnitude: the sharded program
        # is a *different XLA compilation* (scene enters as an argument, not
        # a constant-folded closure), so float32 reassociation shifts values
        # by ~1e-4 relative even on a 1-device mesh. The test guards against
        # structural errors (NaN, missing psum, wrong scaling), not ulps.
        scale = np.abs(g_ref).max() + 1e-8
        np.testing.assert_allclose(g_sh, g_ref, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=name)


def test_train_step_decreases_loss_and_stays_finite(setup):
    """Toy inverse rendering: brighten-the-walls target; SGD must descend and
    never write NaN into the parameters (the round-1 regression)."""
    from raytracer795.parallel import shard as par

    scene, rays, bg, key = setup
    mesh = par.make_ray_mesh(8)
    # achievable target: the scene's own render, dimmed — optimizing the
    # material tables toward it must descend. Geometry stays frozen (vertex
    # grads at silhouettes are ~100x the material grads; uniform-lr SGD on
    # both is badly scaled — the per-param lr dict handles exactly this).
    img0 = par.render_rays_sharded(scene, rays, bg, key, mesh)
    target = 0.9 * img0
    lrs = {"diffuse": 1e-4, "specular": 1e-4, "ambient": 1e-4,
           "mirror": 1e-4, "point_intensity": 1e-1}

    losses = []
    cur = scene
    for step in range(3):
        loss, grads, cur = par.train_step_with_grads(
            cur, rays, bg, target, key, mesh, lr=lrs)
        losses.append(float(loss))
        for name, g in grads.items():
            for leaf in jax.tree_util.tree_leaves(g):
                assert bool(jnp.all(jnp.isfinite(leaf))), (step, name)
        assert np.isfinite(np.asarray(cur.materials.diffuse)).all()
        assert np.isfinite(np.asarray(cur.vertices)).all()
    assert losses[-1] < losses[0], losses
