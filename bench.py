"""Headline benchmark: Cornell-box path trace, rays/sec on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "device": {...}, ...}

The scene is the reference's flagship capability (pages/Page7.md): Monte
Carlo path tracing with NEE + importance sampling, mirror + dielectric
spheres, mesh light, 6 bounces. Rays are counted as the wavefront lanes the
device actually traces: lanes x bounces x (1 extension + 1 NEE occlusion)
— dead lanes are masked math but still occupy the device, so this is
the gross device-throughput number; ``net_rays_per_s`` counts live lanes.

Refuses to run without a GPU: a CPU number is not a device number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SCENE = os.path.join(_HERE, "tests", "scenes", "cornellbox_pt.xml")

RES = int(os.environ.get("BENCH_RES", "800"))
SPP = int(os.environ.get("BENCH_SPP", "4"))
REPS = 5


def main() -> None:
    from raytracer795 import render as render_mod
    from raytracer795.scene.loader import load_scene
    from raytracer795.utils import compile_cache, device

    compile_cache.configure()
    dev = device.require_gpu("bench.py")
    loaded = load_scene(_SCENE)
    cam0 = loaded.cameras[0]
    g = 1
    while g * g < SPP:
        g += 1
    loaded.cameras[0] = dataclasses.replace(
        cam0, nx=RES, ny=RES, num_samples=SPP, grid=g)
    scene = loaded.scene

    # traced rays per frame: every lane runs max_depth bounces; each bounce
    # traces 1 extension ray + 1 NEE occlusion ray per object light.
    n_obj_lights = len(scene.sphere_lights) + len(scene.mesh_lights)
    n_classic = int(scene.lights.point_pos.shape[0]
                    + scene.lights.dir_dir.shape[0]
                    + scene.lights.spot_pos.shape[0]
                    + scene.lights.area_pos.shape[0])
    traces_per_bounce = 1 + (n_obj_lights if scene.pt_nee else 0) + n_classic
    lanes = RES * RES * SPP
    rays_per_frame = lanes * scene.max_depth * traces_per_bounce

    # warm-up (compile)
    img = render_mod.render_camera(loaded, 0, seed=0, spp=SPP, ldr=True)

    best = float("inf")
    for i in range(REPS):
        t0 = time.perf_counter()
        img = render_mod.render_camera(loaded, 0, seed=i + 1, spp=SPP, ldr=True)
        best = min(best, time.perf_counter() - t0)

    del img
    # survivor-weighted (net) count: one full re-render with live-lane
    # counters, outside the timed region
    net_rays = render_mod.count_net_rays(loaded, 0, seed=1, spp=SPP)
    render_mod.log_render_stats(scene, loaded.cameras[0], best, SPP,
                                net_rays=net_rays)
    print(json.dumps({
        "metric": f"rays/s (Cornell path trace {RES}x{RES} {SPP}spp, "
                  f"depth {scene.max_depth}, NEE+IS; gross device lanes — "
                  f"net live-lane number in net_rays_per_s)",
        "value": rays_per_frame / best,
        "unit": "rays/s",
        "net_rays_per_s": net_rays / best,
        "frame_seconds_best_of": [best, REPS],
        "device": dev,
    }))


if __name__ == "__main__":
    main()
