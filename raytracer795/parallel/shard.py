"""Multi-chip SPMD rendering and differentiable optimization.

The reference's only parallelism is 8 POSIX threads interleaving pixel
columns on one box (src/Scene.cpp:269-292,340-356; rationale
pages/Page3.md:101 — hot pixels cluster, so work is dealt modulo the worker
count for load balance). The analogue here is SPMD data parallelism
over the flat ray batch: rays/pixels are block-sharded over a 1-D device
mesh axis, the scene (geometry, BVH, materials, textures, lights) is
replicated — exactly the reference's shared read-only scene — and the only
cross-chip traffic is

  * nothing at all in the forward render (each chip shades its own lanes;
    the film tiles are gathered by the host when it assembles the image), and
  * one ``psum`` of parameter gradients in the backward pass (the renderer's
    equivalent of gradient all-reduce in data-parallel training).

XLA inserts and schedules the collective from the ``shard_map`` specs
below (NCCL over NVLink between the cards of one host).

Because camera lanes are embarrassingly parallel, the same program scales
from 1 card to many without code changes: ``make_ray_mesh`` just enumerates
more devices. Block (contiguous) sharding is used rather than the
reference's modulo interleave: lanes here cost near-uniform time since the
wavefront loop is fixed-depth masked math, so interleaving buys nothing and
contiguous tiles keep the host-side film assembly a cheap reshape.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracer795.models import path_tracer, whitted
from raytracer795.ops import intersect
from raytracer795.scene import types as T

RAY_AXIS = "rays"


def make_ray_mesh(n_devices: int | None = None, local: bool = False) -> Mesh:
    """1-D device mesh over the ray/pixel batch axis.

    ``local=True`` uses only this process' addressable devices (the
    multi-host renderer shards bands per process, distributed.py).
    """
    devs = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def _integrator(scene: T.Scene, differentiable: bool = False,
                whitted_iters: int | None = None):
    """Pick the scene's integrator.

    For the Whitted lane machine, forward-only rendering keeps the
    early-exit ``while_loop``; differentiable callers pass a static trip
    count — ideally the measured one (see ``resolve_whitted_iters``), since
    the fallback dielectric bound is 2^(D+1).
    """
    if scene.renderer == "pathtracing":
        return path_tracer.render_rays
    return functools.partial(whitted.render_rays,
                             differentiable=differentiable,
                             max_iters=whitted_iters)


def resolve_whitted_iters(scene: T.Scene, rays: intersect.Rays,
                          bg_radiance, key, margin: int = 2) -> int | None:
    """Measured Whitted trip count + margin (None for the path tracer).

    One forward render (early-exit while_loop) measures the deepest lane's
    actual ray-tree size; the differentiable fori_loop then runs
    ``measured + margin`` iterations instead of the exponential worst case.
    The margin absorbs tree-shape changes under the infinitesimal parameter
    perturbations gradients probe (topology is piecewise-constant).
    """
    if scene.renderer == "pathtracing":
        return None
    measured = whitted.forward_iteration_count(scene, rays, bg_radiance, key)
    return measured + margin


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def render_rays_sharded(scene: T.Scene, rays: intersect.Rays,
                        bg_radiance: jnp.ndarray, key: jax.Array,
                        mesh: Mesh) -> jnp.ndarray:
    """Render a ray batch with lanes sharded over the mesh's ray axis.

    Lane count must be divisible by the mesh size (callers pad; dead lanes
    are free — they are masked math in the wavefront loop).
    """
    return _cached_render_fn(mesh, scene.renderer)(scene, rays, bg_radiance,
                                                   key)


@functools.lru_cache(maxsize=64)
def _cached_render_fn(mesh: Mesh, renderer: str):
    """Cached jitted sharded forward render (see _cached_loss_grads_fn for
    why the closure must not be rebuilt per call)."""
    def integrator(scene_, *a):
        if renderer == "pathtracing":
            return path_tracer.render_rays(scene_, *a)
        return whitted.render_rays(scene_, *a, differentiable=False)

    def shard_render(scene_, rays_, bg_, key_):
        # decorrelate each chip's sampler streams
        key_ = jax.random.fold_in(key_, jax.lax.axis_index(RAY_AXIS))
        return integrator(scene_, rays_, bg_, key_)

    smapped = jax.shard_map(
        shard_render, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    repl = NamedSharding(mesh, P())
    lane = NamedSharding(mesh, P(RAY_AXIS))
    return jax.jit(smapped, in_shardings=(repl, lane, lane, repl),
                   out_shardings=lane)


# --------------------------------------------------------------------------
# Differentiable parameters and the data-parallel train step
# --------------------------------------------------------------------------

def differentiable_params(scene: T.Scene) -> Dict[str, Any]:
    """The scene leaves we optimize: material tables, light powers, vertices.

    These are the reference's hand-authored XML quantities
    (src/Material.h:10-33, src/Parser.h:1197-1315, VertexData) — here they
    are first-class trainable arrays.
    """
    return {
        "diffuse": scene.materials.diffuse,
        "specular": scene.materials.specular,
        "mirror": scene.materials.mirror,
        "ambient": scene.materials.ambient,
        "point_intensity": scene.lights.point_intensity,
        "dir_radiance": scene.lights.dir_radiance,
        "spot_intensity": scene.lights.spot_intensity,
        "area_radiance": scene.lights.area_radiance,
        "mesh_light_radiance": tuple(ml.radiance for ml in scene.mesh_lights),
        "sphere_light_radiance": tuple(sl.radiance
                                       for sl in scene.sphere_lights),
        "vertices": scene.vertices,
        # texture images are differentiable through the bilinear gathers
        # (src/Texture.cpp:111-131 being the reference's sampling contract)
        "texture_images": tuple(t.image for t in scene.textures),
    }


def scene_with_params(scene: T.Scene, params: Dict[str, Any]) -> T.Scene:
    """Rebuild the scene pytree with the trainable leaves swapped in."""
    import dataclasses

    mats = dataclasses.replace(
        scene.materials, diffuse=params["diffuse"],
        specular=params["specular"], mirror=params["mirror"],
        ambient=params["ambient"])
    lights = dataclasses.replace(
        scene.lights, point_intensity=params["point_intensity"],
        dir_radiance=params["dir_radiance"],
        spot_intensity=params["spot_intensity"],
        area_radiance=params["area_radiance"])
    textures = tuple(
        dataclasses.replace(t, image=im)
        for t, im in zip(scene.textures, params["texture_images"]))
    mesh_lights = tuple(
        dataclasses.replace(ml, radiance=r)
        for ml, r in zip(scene.mesh_lights, params["mesh_light_radiance"]))
    sphere_lights = tuple(
        dataclasses.replace(sl, radiance=r)
        for sl, r in zip(scene.sphere_lights, params["sphere_light_radiance"]))
    return dataclasses.replace(
        scene, materials=mats, lights=lights, mesh_lights=mesh_lights,
        sphere_lights=sphere_lights, vertices=params["vertices"],
        textures=textures)


def train_step(scene: T.Scene, rays: intersect.Rays,
               bg_radiance: jnp.ndarray, target: jnp.ndarray,
               key: jax.Array, mesh: Mesh, lr: float = 1e-2,
               whitted_iters: int | None = None
               ) -> Tuple[jnp.ndarray, T.Scene]:
    """One data-parallel inverse-rendering step; returns (loss, new scene)."""
    loss, _, new_scene = train_step_with_grads(scene, rays, bg_radiance,
                                               target, key, mesh, lr,
                                               whitted_iters)
    return loss, new_scene


def train_step_with_grads(scene: T.Scene, rays: intersect.Rays,
                          bg_radiance: jnp.ndarray, target: jnp.ndarray,
                          key: jax.Array, mesh: Mesh, lr: float = 1e-2,
                          whitted_iters: int | None = None
                          ) -> Tuple[jnp.ndarray, Dict[str, Any], T.Scene]:
    """One data-parallel inverse-rendering step: render → MSE → psum(grad).

    Rays and the target image are sharded over the ray axis; the scene
    (including the trainable parameters) is replicated. Each chip computes
    the loss and parameter gradients of ITS lanes; one ``psum`` over the ray
    axis all-reduces both, after which every chip applies the identical SGD
    update — the canonical DP layout (scaling-book recipe), with the film
    axis playing the role of the batch axis.

    Returns (global loss, psum'd gradient dict, updated scene).
    """
    params = differentiable_params(scene)
    if whitted_iters is None:
        whitted_iters = resolve_whitted_iters(scene, rays, bg_radiance, key)
    fn = _cached_loss_grads_fn(mesh, whitted_iters, scene.renderer)
    loss, grads = fn(params, scene, rays, bg_radiance, target, key)
    # lr may be a scalar or a {param name: scalar} dict (params live on very
    # different scales: vertex grads at silhouettes dwarf material grads)
    def rate(name):
        return lr.get(name, 0.0) if isinstance(lr, dict) else lr

    # Normalize the shard_map outputs to plain host arrays before the SGD
    # update: they carry the mesh's Auto axis context in their aval, and
    # feeding context-typed params back in would miss the jit cache and
    # recompile the whole backward program on the SECOND step (measured
    # ~80 s/step on CPU). Parameter tables are small next to a render.
    grads_h = jax.device_get(grads)
    params_h = jax.device_get(params)
    new_params = {
        name: jax.tree.map(lambda p_, g_: p_ - rate(name) * g_,
                           params_h[name], grads_h[name])
        for name in params
    }
    return loss, grads, scene_with_params(scene, new_params)


@functools.lru_cache(maxsize=64)
def _cached_loss_grads_fn(mesh: Mesh, whitted_iters, renderer: str):
    """Build + cache the jitted sharded loss/grad program.

    jax.jit keys its cache on the FUNCTION OBJECT; defining the shard_map'd
    closure inside train_step_with_grads recompiled the full backward
    render on every optimizer step (~2 min each on CPU). Caching on
    (mesh, trip count, renderer) makes repeated steps hit the compiled
    program — scene/params enter as arguments (pytree-prefix specs), so
    parameter VALUES never key the cache and jit still distinguishes
    different scene structures.
    """
    def integrator(scene_, *a, **k):
        if renderer == "pathtracing":
            return path_tracer.render_rays(scene_, *a, **k)
        return whitted.render_rays(scene_, *a, differentiable=True,
                                   max_iters=whitted_iters, **k)

    n_dev = int(mesh.devices.size)

    def shard_loss_grads(params_, scene_, rays_, bg_, target_, key_):
        key_ = jax.random.fold_in(key_, jax.lax.axis_index(RAY_AXIS))
        n_total = rays_.o.shape[0] * n_dev      # rays_ is the local shard

        def loss_fn(p):
            sc = scene_with_params(scene_, p)
            img = integrator(sc, rays_, bg_, key_)
            return jnp.sum((img - target_) ** 2) / (3.0 * n_total)

        loss, grads = jax.value_and_grad(loss_fn)(params_)
        loss = jax.lax.psum(loss, RAY_AXIS)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, RAY_AXIS), grads)
        return loss, grads

    smapped = jax.shard_map(
        shard_loss_grads, mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    # Explicit in_shardings: step 0 feeds uncommitted host arrays, step 1
    # feeds the previous step's committed replicated outputs — without
    # pinned shardings that difference recompiled the program once more.
    repl = NamedSharding(mesh, P())
    lane = NamedSharding(mesh, P(RAY_AXIS))
    return jax.jit(smapped,
                   in_shardings=(repl, repl, lane, lane, lane, repl),
                   out_shardings=(repl, repl))


def shard_rays(rays: intersect.Rays, mesh: Mesh) -> intersect.Rays:
    """Device-put a ray batch with lanes block-sharded over the mesh."""
    sh = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sh), rays)
