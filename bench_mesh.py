"""Mesh benchmark: rays/sec through the BVH traversal kernel on one GPU.

Prints one JSON line per scene, like bench.py's:
  1. rock100k: a 101k-triangle procedural rock;
  2. instances_rock: 36 MeshInstances + their base mesh sharing one BVH;
  3. rock1800k: a 1,800,900-triangle rock in one BVH — the scale of the
     reference's flagship dragon (pages/Page2.md:57: 1.8M triangles).
Each frame traces one nearest-hit wavefront plus one any-hit shadow
wavefront per point light per depth (Whitted, depth 2, two point lights).
RT795_PALLAS=0 measures the plain jnp traversal instead of the kernel.

Run: python bench_mesh.py   (BENCH_RES overrides the 800x800 default;
BENCH_INSTANCES=0 / BENCH_DRAGON=0 skip scenes). Refuses to run without a
GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SCENES = os.path.join(_HERE, "tests", "scenes")

RES = int(os.environ.get("BENCH_RES", "800"))
SPP = int(os.environ.get("BENCH_SPP", "4"))
REPS = 6


def bench_scene(xml_name: str, label: str, res: int, spp: int,
                dev: dict) -> None:
    from raytracer795 import render as render_mod
    from raytracer795.scene.loader import load_scene

    g = 1
    while g * g < spp:
        g += 1
    loaded = load_scene(os.path.join(_SCENES, xml_name))
    loaded.cameras[0] = dataclasses.replace(
        loaded.cameras[0], nx=res, ny=res, num_samples=spp, grid=g)
    scene = loaded.scene
    n_tris = sum(gr.n_tris for gr in scene.groups)

    n_lights = int(scene.lights.point_pos.shape[0])
    lanes = res * res * spp
    # per depth level: 1 nearest wavefront + one any-hit per light
    rays_per_frame = lanes * scene.max_depth * (1 + n_lights)

    img = render_mod.render_camera(loaded, 0, seed=0, spp=spp,
                                   ldr=True)   # compile
    best = float("inf")
    for i in range(REPS):
        t0 = time.perf_counter()
        img = render_mod.render_camera(loaded, 0, seed=i + 1, spp=spp,
                                       ldr=True)
        best = min(best, time.perf_counter() - t0)

    del img
    net_rays = render_mod.count_net_rays(loaded, 0, seed=1, spp=spp)
    render_mod.log_render_stats(scene, loaded.cameras[0], best, spp,
                                net_rays=net_rays)
    print(json.dumps({
        "metric": f"rays/s ({label} {n_tris} tris, Whitted {res}x{res}"
                  f" {spp}spp, depth {scene.max_depth},"
                  f" {n_lights} shadow lights)",
        "value": rays_per_frame / best,
        "unit": "rays/s",
        "net_rays_per_s": net_rays / best,
        "frame_seconds_best_of": [best, REPS],
        "traversal": ("jnp" if os.environ.get("RT795_PALLAS") == "0"
                      else "kernel"),
        "device": dev,
    }))


def main() -> None:
    from raytracer795.utils import compile_cache, device

    compile_cache.configure()
    dev = device.require_gpu("bench_mesh.py")
    bench_scene("rock100k.xml", "rock100k", RES, SPP, dev)
    if os.environ.get("BENCH_INSTANCES", "1") != "0":
        bench_scene("instances_rock.xml", "instances_rock 37-group", RES,
                    SPP, dev)
    if os.environ.get("BENCH_DRAGON", "1") != "0":
        sys.path.insert(0, _SCENES)
        import make_assets

        make_assets.ensure_rock(os.path.join(_SCENES, "rock1800k.ply"),
                                1350, 668)
        bench_scene("rock1800k.xml", "rock1800k", RES, 1, dev)


if __name__ == "__main__":
    main()
