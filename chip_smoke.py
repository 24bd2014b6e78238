"""On-card smoke test: the renderer's main path, end to end, on one GPU.

Run from the repository root:

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the sharded phase only

Everything runs in this one process (a second JAX process could not open
the card); ``nvidia-smi`` runs in a child that never imports JAX.

Phases (one card):
1. device: device list, JAX version, card name and power limit, compile
   cache directory; exits non-zero unless JAX's first device is a GPU.
2. kernels vs reference: the traversal kernel (ops/bvh_kernel.py) at
   MAX_LANES = 2^18 lanes — rock100k primaries and their shadow rays, and
   the same on the 1.8M-triangle BVH of rock1800k — against the jnp walk on
   the same card, within the tolerances below; each wavefront timed on
   both (median of 5 warm calls).
3. kernel vs XLA: each mesh frame at bench size (rock100k and
   instances_rock at 800x800 4 spp, rock1800k at 800x800 1 spp) with the
   kernel and with the plain jnp walk (RT795_PALLAS=0); compile time apart.
4. main path: ``render.main`` on cornellbox, rock100k, instances_rock and
   rock1800k against the reference goldens at the test suite's bounds; the
   Cornell path trace at bench size (800x800 4 spp); a 64x64 2 spp Cornell
   path trace on the GPU and on this process' CPU backend, same seed.
5. the ``gpu``-marked tests, in-process through pytest.

``--four`` (four cards, and nothing else): ``render_rays_sharded`` on the
Cornell path trace at 256x256 1 spp against the same rays and keys on one
card, and one ``train_step_with_grads`` on the Cornell box against the
one-card step.

Tolerances of the kernel against the jnp walk on the card: hit/miss
agrees on all but <= 1e-4 of lanes, the primitive index on >= 1 - 1e-4 of
lanes both hit, |dt|/|t| <= 1e-5 where the primitives agree, any-hit on
>= 1 - 1e-4 of lanes (Triton and XLA may contract multiply-adds into FMAs
differently, so rays grazing an edge can flip).

Any failed phase raises: the process exits non-zero and prints no result.
The last line of standard output is, only when every phase passed:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SCENES = os.path.join(_HERE, "tests", "scenes")
_GOLDENS = os.path.join(_HERE, "tests", "goldens")
_OUT = os.path.join(_HERE, "chiprun_out", "smoke")

# The CPU backend is needed beside the GPU for the phase-4 comparison.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracer795 import render as render_mod  # noqa: E402
from raytracer795.models import camera as camera_model  # noqa: E402
from raytracer795.ops import intersect  # noqa: E402
from raytracer795.scene.loader import load_scene  # noqa: E402
from raytracer795.utils import compile_cache, device, image_io  # noqa: E402
from raytracer795.utils.vec3 import Vec3  # noqa: E402

LANES = render_mod.MAX_LANES
HIT_MISMATCH_MAX = 1e-4
PRIM_AGREE_MIN = 1 - 1e-4
REL_DT_MAX = 1e-5
ANYHIT_AGREE_MIN = 1 - 1e-4
KERNEL_REPS = 3
JNP_REPS = 1
WAVEFRONT_REPS = 5
# 64x64 2 spp Cornell path trace, GPU vs CPU: mean |difference| of the two
# images after the same exposure (99th percentile of the CPU image -> 255),
# in LDR levels. The sampled paths are the same (same seed, same counter-
# based RNG); float differences (FMA contraction, transcendental
# implementations) can flip a few Russian-roulette, BRDF-sampling or
# grazing-hit decisions, each of which moves one pixel far. A broken GPU
# path moves every pixel.
CPU_GPU_LDR_MEAN_MAX = 2.0


def log(*a):
    print(*a, flush=True)


def ensure_rock1800k():
    sys.path.insert(0, _SCENES)
    import make_assets

    make_assets.ensure_rock(os.path.join(_SCENES, "rock1800k.ply"),
                            1350, 668)


def with_camera(loaded, res, spp):
    g = 1
    while g * g < spp:
        g += 1
    loaded.cameras[0] = dataclasses.replace(
        loaded.cameras[0], nx=res, ny=res, num_samples=spp, grid=g)
    return loaded


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def phase_device() -> tuple[dict, str]:
    """(device record, card) — card() raises without nvidia-smi's line."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU, but JAX found none "
                         f"(first device platform {devs[0].platform!r})")
    log("devices:", devs)
    log("jax", jax.__version__)
    card = device.card()
    log("card (nvidia-smi name, power.limit):")
    log(card)
    log("compile cache:", compile_cache.configure())
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}, card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def wavefronts(loaded, n):
    """n tile-swizzled primary rays over the scene camera's frustum."""
    side = int(round(n ** 0.5))
    assert side * side == n
    cam = dataclasses.replace(loaded.cameras[0], nx=side, ny=side,
                              num_samples=1, grid=1)
    px, py = camera_model.band_pixels(side, side)
    return camera_model.primary_rays_at(cam, jnp.asarray(px),
                                        jnp.asarray(py))


def check_nearest(name, got, want):
    k1, t1, i1 = map(np.asarray, got)
    k2, t2, i2 = map(np.asarray, want)
    h1, h2 = k1 < 1e38, k2 < 1e38
    mismatch = float((h1 != h2).mean())
    both = h1 & h2
    same = both & (i1 == i2)
    agree = float(same.sum() / max(both.sum(), 1))
    rel = np.abs(t1[same] - t2[same]) / np.maximum(np.abs(t2[same]), 1e-30)
    rel_max = float(rel.max()) if rel.size else 0.0
    log(f"  {name} nearest: lanes {h1.size} hits {int(h1.sum())} "
        f"hit/miss mismatch {mismatch} prim agree {agree} "
        f"max |dt|/|t| {rel_max}")
    assert h1.any(), f"{name}: no ray hit"
    assert mismatch <= HIT_MISMATCH_MAX, (name, mismatch)
    assert agree >= PRIM_AGREE_MIN, (name, agree)
    assert rel_max <= REL_DT_MAX, (name, rel_max)
    return h1, t1


def check_anyhit(name, got, want):
    f1, f2 = np.asarray(got), np.asarray(want)
    agree = float((f1 == f2).mean())
    log(f"  {name} any-hit: lanes {f1.size} occluded {int(f1.sum())} "
        f"agree {agree}")
    assert agree >= ANYHIT_AGREE_MIN, (name, agree)


def median_ms(fn, *args, reps=WAVEFRONT_REPS):
    """Median wall time of ``fn(*args)`` to its result on the device, after
    one warm call."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def kernel_vs_reference(name, loaded, card):
    scene = jax.tree_util.tree_map(jax.lax.stop_gradient, loaded.scene)
    gi = max(range(len(scene.groups)), key=lambda i: scene.groups[i].n_tris)
    g = scene.groups[gi]
    log(f"  {name}: group {gi} {g.n_tris} triangles, "
        f"{g.bvh.first.shape[0]} BVH nodes")
    rays = wavefronts(loaded, LANES)

    kern = jax.jit(lambda s, r: intersect._walk_nearest(
        s, s.groups[gi], r.o, r.d, "on"))
    ref = jax.jit(lambda s, r: intersect._tri_bvh_candidates(
        s, s.groups[gi], r))
    compiled = kern.lower(scene, rays).compile()
    log(f"  {name} nearest kernel memory:", compiled.memory_analysis())
    hit, t = check_nearest(name, compiled(scene, rays), ref(scene, rays))
    log(f"  {name} nearest {LANES} lanes: kernel "
        f"{median_ms(compiled, scene, rays)} ms vs jnp walk "
        f"{median_ms(ref, scene, rays)} ms (median of {WAVEFRONT_REPS}) "
        f"on {card}")

    # shadow rays from the primary hits toward point light 0; misses get
    # t_cap = 0, which no hit satisfies
    p = rays.o + rays.d * jnp.where(hit, t, 1.0)
    lp = scene.lights.point_pos[0]
    d = Vec3(lp[0] - p.x, lp[1] - p.y, lp[2] - p.z)
    shadow = intersect.Rays(o=p + d * 1e-3, d=d, time=rays.time)
    cap = jnp.asarray(hit, jnp.float32)
    kern_a = jax.jit(lambda s, r, c: intersect._walk_anyhit(
        s, s.groups[gi], r.o, r.d, c, "on"))
    ref_a = jax.jit(lambda s, r, c: intersect._tri_bvh_anyhit(
        s, s.groups[gi], r, c))
    compiled_a = kern_a.lower(scene, shadow, cap).compile()
    log(f"  {name} any-hit kernel memory:", compiled_a.memory_analysis())
    check_anyhit(name, compiled_a(scene, shadow, cap),
                 ref_a(scene, shadow, cap))
    log(f"  {name} any-hit {LANES} lanes: kernel "
        f"{median_ms(compiled_a, scene, shadow, cap)} ms vs jnp walk "
        f"{median_ms(ref_a, scene, shadow, cap)} ms (median of "
        f"{WAVEFRONT_REPS}) on {card}")


def phase_kernels(card):
    kernel_vs_reference("rock100k", load_scene(
        os.path.join(_SCENES, "rock100k.xml")), card)
    ensure_rock1800k()
    kernel_vs_reference("rock1800k", load_scene(
        os.path.join(_SCENES, "rock1800k.xml")), card)


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

MESH_FRAMES = [("rock100k", 800, 4), ("instances_rock", 800, 4),
               ("rock1800k", 800, 1)]


def time_frame(loaded, spp, reps):
    """(compile + first frame s, [frame s], image); frames end on host."""
    t0 = time.perf_counter()
    img = render_mod.render_camera(loaded, 0, seed=0, spp=spp)
    first = time.perf_counter() - t0
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        img = render_mod.render_camera(loaded, 0, seed=i + 1, spp=spp)
        times.append(time.perf_counter() - t0)
    return first, times, img


def phase_kernel_vs_xla(card):
    ensure_rock1800k()
    results = {}
    for mode, reps in (("kernel", KERNEL_REPS), ("jnp", JNP_REPS)):
        jax.clear_caches()      # the traversal mode is read at trace time
        if mode == "jnp":
            os.environ["RT795_PALLAS"] = "0"
        try:
            for name, res, spp in MESH_FRAMES:
                loaded = with_camera(load_scene(
                    os.path.join(_SCENES, name + ".xml")), res, spp)
                first, times, img = time_frame(loaded, spp, reps)
                assert img.shape == (res, res, 3), img.shape
                assert np.isfinite(img).all(), f"{name}: non-finite pixels"
                med = float(np.median(times))
                results[(name, mode)] = med
                log(f"  {name} {res}x{res} {spp}spp [{mode}]: compile+first "
                    f"{first:.3f} s, frame s {times} (median {med}) "
                    f"on {card}")
        finally:
            os.environ.pop("RT795_PALLAS", None)
    jax.clear_caches()
    for name, _, _ in MESH_FRAMES:
        k, x = results[(name, "kernel")], results[(name, "jnp")]
        log(f"  {name}: kernel {k} s vs jnp {x} s per frame "
            f"(jnp / kernel = {x / k:.2f}x)")
    return results


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------

GOLDENS = [
    # (scene, check) — the bounds of tests/test_golden.py and test_gpu.py
    ("cornellbox", lambda d: d.mean() < 0.01 and (d > 2).mean() < 0.001),
    ("rock100k", lambda d: (d > 1).mean() < 1e-4),
    ("instances_rock", lambda d: d.mean() < 0.2 and (d > 2).mean() < 0.01),
    ("rock1800k", lambda d: (d > 1).mean() < 1e-4),
]


def exposed_ldr(img, scale):
    return image_io.to_ldr(np.asarray(img, np.float32) * scale).astype(
        np.float32)


def phase_main_path(card):
    ensure_rock1800k()
    os.makedirs(_OUT, exist_ok=True)
    for name, ok in GOLDENS:
        t0 = time.perf_counter()
        render_mod.main([os.path.join(_SCENES, name + ".xml"), "-o", _OUT])
        secs = time.perf_counter() - t0
        img = image_io.read_png(os.path.join(_OUT, name + ".png"))
        gold = image_io.read_ppm(os.path.join(_GOLDENS, name + ".ppm"))
        d = np.abs(img.astype(np.float32) - gold)
        log(f"  golden {name}: mean |diff| {d.mean()} frac>1 "
            f"{(d > 1).mean()} frac>2 {(d > 2).mean()} "
            f"({secs:.2f} s incl. compile)")
        assert ok(d), f"{name} misses its golden bound"

    pt = os.path.join(_SCENES, "cornellbox_pt.xml")
    loaded = with_camera(load_scene(pt), 800, 4)
    first, times, img = time_frame(loaded, 4, KERNEL_REPS)
    assert np.isfinite(img).all(), "cornellbox_pt: non-finite pixels"
    log(f"  cornellbox_pt 800x800 4spp: compile+first {first:.3f} s, "
        f"frame s {times} on {card}")

    gpu_img = render_mod.render_camera(with_camera(load_scene(pt), 64, 2),
                                       0, seed=0, spp=2)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_img = render_mod.render_camera(
            with_camera(load_scene(pt), 64, 2), 0, seed=0, spp=2)
    scale = 255.0 / max(float(np.percentile(cpu_img, 99)), 1e-12)
    d = np.abs(exposed_ldr(gpu_img, scale) - exposed_ldr(cpu_img, scale))
    log(f"  cornellbox_pt 64x64 2spp GPU vs CPU: mean |LDR diff| {d.mean()} "
        f"(bound {CPU_GPU_LDR_MEAN_MAX}), frac>2 {(d > 2).mean()}")
    assert np.isfinite(gpu_img).all() and np.isfinite(cpu_img).all()
    assert d.mean() < CPU_GPU_LDR_MEAN_MAX, d.mean()


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------

class _Outcomes:
    """pytest plugin: count test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests():
    import pytest

    os.environ["RT795_GPU_TESTS"] = "1"
    rec = _Outcomes()
    rc = pytest.main([os.path.join(_HERE, "tests", "test_gpu.py"),
                      "-m", "gpu", "-q", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "--durations=0"], plugins=[rec])
    log("  gpu tests:", rec.counts, "rc", int(rc))
    assert rc == 0 and rec.counts["failed"] == 0, rec.counts
    assert rec.counts["skipped"] == 0 and rec.counts["passed"] >= 5, \
        rec.counts


# --------------------------------------------------------------------------
# --four
# --------------------------------------------------------------------------

def phase_four(devs, res=256, train_res=64):
    """Sharded render and train step on ``devs`` vs one device."""
    from raytracer795.models import path_tracer
    from raytracer795.parallel import shard as par

    n_dev = len(devs)
    mesh = par.make_ray_mesh(n_dev)
    one = jax.sharding.SingleDeviceSharding(devs[0])

    # -- render_rays_sharded, Cornell path trace, res x res at 1 spp ----
    loaded = with_camera(load_scene(os.path.join(
        _SCENES, "cornellbox_pt.xml")), res, 1)
    scene = loaded.scene
    rays = camera_model.primary_rays(loaded.cameras[0])
    n = rays.o.shape[0]
    assert n % n_dev == 0
    bg = jnp.zeros((n, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    img = np.asarray(par.render_rays_sharded(
        scene, par.shard_rays(rays, mesh), bg, key, mesh))
    log(f"  render_rays_sharded {res}x{res} on {n_dev} devices: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    # one device renders each shard's lanes with that shard's key
    # (render_rays_sharded folds the device index into the key)
    shard_fn = jax.jit(path_tracer.render_rays)
    q = n // n_dev
    ref = []
    for i in range(n_dev):
        part = jax.tree_util.tree_map(
            lambda x: jax.device_put(x[i * q:(i + 1) * q], one), rays)
        ref.append(np.asarray(shard_fn(
            scene, part, jax.device_put(bg[:q], one),
            jax.random.fold_in(key, i))))
    ref = np.concatenate(ref)
    d = np.abs(img - ref)
    mean = max(float(np.abs(ref).mean()), 1e-12)
    far = float((d > 1e-3 * mean).any(axis=-1).mean())
    log(f"  sharded vs one device: max |diff| {d.max()} mean {d.mean()} "
        f"(image mean {mean}), lanes off by > 1e-3 x mean: {far}")
    # Same lanes, same keys, same per-lane program: only a different
    # compilation's float rounding separates them, and it may flip a rare
    # sampling decision, which moves that lane far.
    assert np.isfinite(img).all()
    assert far <= 0.01 and d.mean() <= 0.01 * mean, (far, d.mean())

    # -- one train step: Cornell box (Whitted, deterministic) ---------------
    loaded = with_camera(load_scene(os.path.join(
        _SCENES, "cornellbox.xml")), train_res, 1)
    scene = loaded.scene
    rays = camera_model.primary_rays(loaded.cameras[0])
    n = rays.o.shape[0]
    bg = jnp.broadcast_to(jnp.asarray(scene.background), (n, 3))
    target = jnp.full((n, 3), 100.0, jnp.float32)
    iters = par.resolve_whitted_iters(scene, rays, bg, key)
    out = {}
    for label, m in (("one", par.make_ray_mesh(1)), ("all", mesh)):
        t0 = time.perf_counter()
        loss, grads, _ = par.train_step_with_grads(
            scene, par.shard_rays(rays, m), bg, target, key, m,
            whitted_iters=iters)
        out[label] = (float(loss), jax.device_get(grads))
        log(f"  train_step_with_grads on {m.devices.size} device(s): loss "
            f"{out[label][0]} ({time.perf_counter() - t0:.2f} s incl. "
            f"compile)")
    (l1, g1), (l4, g4) = out["one"], out["all"]
    assert np.isfinite(l1) and np.isfinite(l4)
    assert abs(l4 - l1) <= 1e-5 * abs(l1), (l1, l4)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g4)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all(), "non-finite sharded gradient"
        if a.size == 0:
            continue
        scale = max(float(np.abs(a).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    log(f"  gradients, {n_dev} devices vs one: max |diff| / max |grad| "
        f"{worst}")
    # psum adds the per-device partial sums in another order than one
    # device's reduction: float32 reassociation only
    assert worst <= 1e-4, worst


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev, card = phase_device()
    if args.four:
        if dev["count"] < 4:
            raise SystemExit(f"--four needs 4 cards, JAX found "
                             f"{dev['count']}")
        phases = [("four cards", lambda: phase_four(jax.devices()[:4]))]
    else:
        phases = [("kernels vs reference", lambda: phase_kernels(card)),
                  ("kernel vs XLA", lambda: phase_kernel_vs_xla(card)),
                  ("main path", lambda: phase_main_path(card)),
                  ("gpu tests", phase_gpu_tests)]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase: {name}")
        fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
