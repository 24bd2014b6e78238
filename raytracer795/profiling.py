"""Per-stage pipeline profiler: where does a frame's time go?

The reference author profiled externally ("I profiled every step of the
program", pages/Page3.md:97); this is the committed equivalent for the GPU
pipeline. Each stage is jitted and timed in isolation on the same ray batch
(best-of-N wall clock after a warm-up compile), so regressions localize to a
stage instead of a frame number. Every line names the device it ran on;
without a GPU the profiler refuses to run.

CLI:
  python -m raytracer795.profiling scene.xml [--res 512] [--reps 5]
                                       [--trace-dir DIR]

``--trace-dir`` additionally captures a ``jax.profiler`` trace of one full
frame for TensorBoard/Perfetto (SURVEY §5 tracing subsystem).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp

from raytracer795.models import camera as camera_model
from raytracer795.models import path_tracer, whitted
from raytracer795.models.lights import ShadePoint, direct_lighting
from raytracer795.ops import intersect
from raytracer795.ops.texture import apply_textures
from raytracer795.scene.loader import load_scene


def _time(fn, *args, reps=5):
    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))        # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def profile_scene(loaded, res=512, reps=5):
    """Return [(stage, seconds, lanes/s)] for one primary-ray wavefront."""
    scene = loaded.scene
    cam = dataclasses.replace(loaded.cameras[0], nx=res, ny=res,
                              num_samples=1, grid=1)
    rays = jax.tree_util.tree_map(jnp.asarray, camera_model.primary_rays(cam))
    n = rays.o.shape[0]
    key = jax.random.PRNGKey(0)
    bg = jnp.zeros((n, 3), jnp.float32)

    vn = intersect.compute_vertex_normals(
        jax.tree_util.tree_map(jnp.asarray, scene))
    hit = jax.jit(lambda r: intersect.trace(scene, r))(rays)
    det = jax.jit(lambda r, h: intersect.hit_details(scene, r, h, vn))(rays, hit)
    tex = jax.jit(lambda d: apply_textures(scene, d))(det)
    sp = ShadePoint(point=det.point, normal=tex.normal, wo=-rays.d,
                    mat=det.mat, dm=tex.dm, tex_color=tex.tex_color,
                    tex_norm=tex.tex_normalizer, time=rays.time,
                    valid=det.valid)

    integrator = (path_tracer.render_rays
                  if scene.renderer == "pathtracing" else
                  lambda *a: whitted.render_rays(*a, differentiable=False))

    stages = [
        ("ray_gen", lambda: camera_model.primary_rays(cam)),
        ("trace", lambda: intersect.trace(scene, rays)),
        ("trace_anyhit",
         lambda: intersect.trace_anyhit(scene, rays, 100.0)),
        ("hit_details", lambda: intersect.hit_details(scene, rays, hit, vn)),
        ("apply_textures", lambda: apply_textures(scene, det)),
        ("direct_lighting", lambda: direct_lighting(scene, sp, key)),
        ("full_frame", lambda: integrator(scene, rays, bg, key)),
    ]
    out = []
    for name, fn in stages:
        dt = _time(fn, reps=reps)
        out.append((name, dt, n / dt))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-stage render profiler")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", default=None,
                    help="capture a jax.profiler trace of one frame")
    args = ap.parse_args(argv)

    from raytracer795.utils import compile_cache, device

    compile_cache.configure()
    dev = device.require_gpu("profiling")
    loaded = load_scene(args.scene)
    for name, dt, lps in profile_scene(loaded, args.res, args.reps):
        print(json.dumps({"stage": name, "ms": dt * 1e3,
                          "lanes_per_s": lps, "device": dev}))

    if args.trace_dir:
        scene = loaded.scene
        cam = dataclasses.replace(loaded.cameras[0], nx=args.res, ny=args.res,
                                  num_samples=1, grid=1)
        rays = camera_model.primary_rays(cam)
        n = rays.o.shape[0]
        bg = jnp.zeros((n, 3), jnp.float32)
        integrator = (path_tracer.render_rays
                      if scene.renderer == "pathtracing" else
                      lambda *a: whitted.render_rays(*a, differentiable=False))
        jf = jax.jit(lambda r: integrator(scene, r, bg, jax.random.PRNGKey(0)))
        jax.block_until_ready(jf(rays))
        with jax.profiler.trace(args.trace_dir):
            jax.block_until_ready(jf(rays))
        print(json.dumps({"stage": "profiler_trace", "dir": args.trace_dir}))


if __name__ == "__main__":
    main()
