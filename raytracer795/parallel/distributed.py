"""Multi-host SPMD rendering: process bootstrap + per-host film assembly.

The reference has no multi-host story (8 POSIX threads on one box,
src/Scene.cpp:340-356); this is the scale-out layer on top of
parallel/shard.py's SPMD render:

- ``initialize()`` wires the JAX distributed runtime (all cards of all
  processes become ``jax.devices()``); single-process runs are a no-op so
  every entry point works unchanged on one box.
- ``render_camera_distributed()`` renders one camera over all hosts with
  two nested levels of data parallelism: row BANDS interleave over
  processes modulo the process count (the reference's thread-modulo
  load-balance insight, pages/Page3.md:101, lifted to hosts), and within
  an owned band the lanes shard over that process' local devices via
  shard_map. The forward render needs no cross-device collectives at
  all; the per-process films are summed by one process-level allgather at
  the end (host-driven). Banding, sample chunking, and accumulation
  are render.render_camera's single code path (launcher hook) — full
  multisampling and lane-budget tiling included.

Failure / elastic recovery story (SURVEY §5): every band render is a pure
function of (scene, camera, seed, band) — idempotent tiles. A crashed job
is simply relaunched, with ANY process count: band ownership is
(band index % process_count), so a different world size partitions the
same deterministic band results and the assembled film is identical
(tested: 2-process film == 1-process film bit-for-bit on deterministic
scenes). Long single-host renders additionally checkpoint/resume through
render.FilmCheckpoint.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from raytracer795.models import camera as camera_model
from raytracer795.parallel import shard as par
from raytracer795.render import _background_radiance
from raytracer795.scene import types as T


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None) -> int:
    """Bring up the JAX distributed runtime; returns this process' id.

    Arguments default to the env vars JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID and JAX_LOCAL_DEVICE_IDS (comma
    list). Without device ids a process opens every card of its host, which
    is right for one process per host. Several processes on one GPU host
    must each be given their own cards (JAX_LOCAL_DEVICE_IDS), or be
    launched by a cluster manager jax.distributed detects (SLURM, Open MPI,
    ...), which gives each local rank its own card. With no coordinator
    configured (single process) this is a no-op returning 0.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None \
            and "JAX_NUM_PROCESSES" not in os.environ:
        return 0        # single-process: nothing to initialize
    # jax.distributed.initialize only auto-detects cluster envs (SLURM,
    # OMPI, ...); the generic names this CLI documents are parsed here.
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if local_device_ids is None and os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        local_device_ids = [
            int(i) for i in os.environ["JAX_LOCAL_DEVICE_IDS"].split(",")]
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    return jax.process_index()


def _pad_lanes(rays, multiple: int):
    """Pad the lane axis with NaN rays (matched nothing, masked math)."""
    n = rays.o.x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return rays, n

    def padf(x):
        return jnp.concatenate([x, jnp.full((pad,), jnp.nan, x.dtype)])

    return jax.tree_util.tree_map(padf, rays), n


def _sharded_launchers(mesh, pid: int, nproc: int):
    """Band launchers for render.render_camera with two levels of
    parallelism: bands interleave over PROCESSES modulo the process count
    (the reference's thread-modulo load-balance insight, pages/Page3.md:101,
    lifted to hosts), and within an owned band the lanes shard over this
    process' device mesh (shard.render_rays_sharded). Non-owned bands
    return zeros without touching a device; the caller sums the per-process
    films (one process-level allgather at the end — the forward render
    needs NO cross-device collectives, film assembly is host work).

    Sampler-key semantics match render.py's launchers exactly EXCEPT the
    per-device fold_in inside render_rays_sharded — deterministic scenes
    (no stochastic shading draws) are bit-identical to the single-process
    unsharded render.
    """
    from raytracer795.render import _band_px_py, _integrator  # noqa: F401

    n_dev = mesh.devices.size
    seen = {}

    def owner(row0: int) -> int:
        if row0 not in seen:
            seen[row0] = len(seen)
        return seen[row0] % nproc

    def run(scene, rays, bga, key):
        rays, n = _pad_lanes(rays, n_dev)
        pad = rays.o.x.shape[0] - n
        if pad:
            bga = jnp.concatenate([bga, jnp.zeros((pad, 3), bga.dtype)])
        img = par.render_rays_sharded(scene, rays, bga, key, mesh)
        return np.asarray(img)[:n]

    def single(scene, cam, key, row0, n_rows):
        if owner(int(row0)) != pid:
            return np.zeros((n_rows * cam.nx, 3), np.float32)
        px, py = _band_px_py(cam, row0, n_rows)
        rays = camera_model.primary_rays_at(cam, px, py)
        uv = (px.astype(jnp.float32) / cam.nx,
              py.astype(jnp.float32) / cam.ny)
        bg = _background_radiance(scene, rays, uv, True)
        bga = jnp.nan_to_num(bg.to_array().reshape(-1, 3))
        return run(scene, rays, bga, key)

    def sample_range(scene, cam, key, base, count, row0, n_rows):
        if owner(int(row0)) != pid:
            return np.zeros((n_rows * cam.nx, 3), np.float32)
        if n_rows < cam.ny:
            key = jax.random.fold_in(key, row0)
        px, py = _band_px_py(cam, row0, n_rows)
        rays = camera_model.sample_rays_at(cam, key, px, py, base, count)
        uv = (jnp.repeat(px.astype(jnp.float32) / cam.nx, count),
              jnp.repeat(py.astype(jnp.float32) / cam.ny, count))
        bg = _background_radiance(scene, rays, uv, False)
        bga = jnp.nan_to_num(bg.to_array().reshape(-1, 3))
        out = run(scene, rays, bga, key)
        return out.reshape(-1, count, 3).mean(axis=1)

    return single, sample_range


def render_camera_distributed(loaded: T.LoadedScene, cam_index: int = 0,
                              seed: int = 0, mesh=None,
                              spp: int | None = None) -> np.ndarray:
    """Render one camera over all devices of all processes -> [ny, nx, 3].

    Reuses render.render_camera's band/chunk/accumulate machinery via its
    launcher hook (full multisampling + row-band tiling — no duplicated
    1-spp path): each process renders its modulo-interleaved share of the
    row bands on its LOCAL device mesh, then one process-level allgather
    sums the per-process films on every host. On a single process this
    degenerates to the local sharded render.
    """
    from raytracer795 import render as render_mod

    pid = jax.process_index()
    nproc = jax.process_count()
    if mesh is None:
        mesh = par.make_ray_mesh(local=True)
    film = render_mod.render_camera(
        loaded, cam_index, seed=seed, spp=spp,
        _launchers=_sharded_launchers(mesh, pid, nproc))
    if nproc > 1:
        from jax.experimental import multihost_utils

        # Coordination-service barrier BEFORE the allgather: each process
        # compiles only its own bands, so arrival skew can exceed the CPU
        # collective backend's 30 s rendezvous timeout (observed: 80 s on a
        # cold compile). The barrier rides the distributed KV service (no
        # device collectives) and waits arbitrarily long.
        _coordination_barrier()
        film = np.asarray(multihost_utils.process_allgather(film)).sum(0)
    return film


_BARRIER_N = [0]


def _coordination_barrier(timeout_ms: int = 60 * 60 * 1000) -> None:
    """Host-level barrier via the jax.distributed coordination service."""
    try:
        from jax._src import distributed as _dist

        client = _dist.global_state.client
        if client is not None:
            _BARRIER_N[0] += 1
            client.wait_at_barrier(f"rt795_film_{_BARRIER_N[0]}", timeout_ms)
    except Exception:
        pass        # best-effort: the allgather itself still synchronizes


def main(argv=None):
    """CLI: python -m raytracer795.parallel.distributed scene.xml

    One process per host (launch identically on every host with the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars
    set; add JAX_LOCAL_DEVICE_IDS where several processes share a host);
    process 0 writes the images.
    """
    import argparse

    from raytracer795.scene.loader import load_scene
    from raytracer795.utils import compile_cache, image_io

    ap = argparse.ArgumentParser(description="multi-host SPMD renderer")
    ap.add_argument("scene")
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spp", type=int, default=None,
                    help="override NumSamples for every camera")
    args = ap.parse_args(argv)

    pid = initialize()
    compile_cache.configure()
    loaded = load_scene(args.scene)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, cam in enumerate(loaded.cameras):
        film = render_camera_distributed(loaded, i, seed=args.seed,
                                         spp=args.spp)
        if pid == 0:
            path = os.path.join(args.out_dir, cam.image_name)
            image_io.save_image(path, film)
            print(f"[distributed] {cam.image_name}: {cam.nx}x{cam.ny} "
                  f"on {jax.device_count()} devices / "
                  f"{jax.process_count()} processes")


if __name__ == "__main__":
    main()
