"""Vectorized camera ray generation (lane-major Vec3 output).

One broadcasted computation produces every primary/sample ray of a frame
([H*W*S] component SoA), replacing the per-pixel loops of
src/Camera.cpp:63-139 and src/Scene.cpp:365-411. RNG is counter-based
(jax.random over a fold_in'd key) instead of the reference's shared mt19937
— statistically equivalent jittered sampling, deterministic per (key, frame).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracer795.ops.intersect import Rays
from raytracer795.scene.types import Camera
from raytracer795.utils.vec3 import Vec3, vdot, vnormalize


# Pixel tile of the lane swizzle: consecutive lanes cover one TILE_W x
# TILE_H tile. It bounds how far apart the rays of one traversal program
# (ops/bvh_kernel.py) can start; 64x64 is not measured on this card.
TILE_W = 64
TILE_H = 64


def band_pixels(nx: int, n_rows: int, tile_w: int = TILE_W,
                tile_h: int = TILE_H):
    """Lane -> (px, py_in_band) in tile-swizzled order. Host numpy, O(N).

    Lanes enumerate the band tile-by-tile (64x64 pixel tiles, row-major
    inside a tile, edge tiles clipped) instead of image-row-major. A
    traversal program walks a block of consecutive lanes and runs until
    its slowest ray is done, so rays whose frusta are close keep its lanes
    on similar walks; row-major lanes would form a long strip across the
    image. Shadow and bounce wavefronts inherit the order — their origins
    are the block's hit points, which stay spatially clustered. The mapping
    is a pure-arithmetic bijection: no gathers on device; the film is
    unswizzled once per band on the host (render.py).
    """
    tile_h = min(tile_h, max(1, n_rows))
    lane = np.arange(n_rows * nx, dtype=np.int64)
    row_band = nx * tile_h                      # lanes per tile-row
    tr = lane // row_band
    r = lane - tr * row_band
    th_eff = np.minimum(tile_h, n_rows - tr * tile_h)   # clipped bottom row
    tile_area = tile_w * th_eff
    tc = r // tile_area
    c = r - tc * tile_area
    tw_eff = np.minimum(tile_w, nx - tc * tile_w)       # clipped right tile
    px = tc * tile_w + c % tw_eff
    py = tr * tile_h + c // tw_eff
    return px.astype(np.int32), py.astype(np.int32)


def band_unswizzle_index(nx: int, n_rows: int):
    """Host index: ``film_flat[idx] = band_output`` undoes band_pixels."""
    px, py = band_pixels(nx, n_rows)
    return py.astype(np.int64) * nx + px


def primary_rays_at(cam: Camera, px, py) -> Rays:
    """Center-of-pixel rays for per-lane pixel coords (src/Camera.cpp:63-72).

    ``px``/``py`` are [N] integer arrays in FRAME coordinates (py may be a
    traced row offset plus a static band-local array).
    """
    nx, ny = cam.nx, cam.ny
    x = (px + 0.5) / nx
    y = (py + 0.5) / ny
    ub = cam.left + (cam.right_edge - cam.left) * x         # [N]
    vb = cam.top - (cam.top - cam.bottom) * y               # [N]
    pos = np.asarray(cam.pos, np.float32)
    gaze = np.asarray(cam.gaze, np.float32)
    right = np.asarray(cam.right, np.float32)
    up = np.asarray(cam.up, np.float32)
    m = Vec3(
        pos[0] + gaze[0] * cam.near_distance + ub * right[0] + vb * up[0],
        pos[1] + gaze[1] * cam.near_distance + ub * right[1] + vb * up[1],
        pos[2] + gaze[2] * cam.near_distance + ub * right[2] + vb * up[2])
    d = vnormalize(m - Vec3(pos[0], pos[1], pos[2]))
    n = m.x.shape[0]
    o = Vec3(jnp.full((n,), pos[0]), jnp.full((n,), pos[1]),
             jnp.full((n,), pos[2]))
    return Rays(o=o, d=d, time=jnp.zeros((n,)))


def primary_rays(cam: Camera, row0=0, n_rows: int | None = None) -> Rays:
    """Center-of-pixel rays, time 0, image-row-major lane order.

    ``row0`` (traced ok) + static ``n_rows`` select a horizontal band so
    frames larger than the lane budget tile row-wise with one compilation.
    """
    nx, ny = cam.nx, cam.ny
    if n_rows is None:
        n_rows = ny
    px = jnp.broadcast_to(jnp.arange(nx)[None, :], (n_rows, nx)).reshape(-1)
    py = row0 + jnp.broadcast_to(jnp.arange(n_rows)[:, None],
                                 (n_rows, nx)).reshape(-1)
    return primary_rays_at(cam, px, py)


def sample_rays(cam: Camera, key: jax.Array) -> Rays:
    """All jittered sample rays of a frame: [ny*nx*S] SoA."""
    return sample_rays_range(cam, key, 0, cam.num_samples)


def sample_rays_at(cam: Camera, key: jax.Array, px, py, base,
                   count: int) -> Rays:
    """Jittered sample rays for per-lane pixel coords (sample-major lanes).

    ``px``/``py`` are [P] integer pixel coordinates (frame space); output
    lanes are [P*count] with the count samples of a pixel consecutive.
    ``count`` is static; ``base`` may be a traced scalar so one compiled
    program serves every sample chunk of a frame.

    Grid placement per getSampleRay (src/Camera.cpp:94-113): sample s sits in
    sub-pixel cell (s % g, s // g) of a g x g grid (g = ceil-sqrt of S) with
    uniform jitter. With DoF the ray starts on the lens and gets time 0
    (src/Camera.cpp:119-139); otherwise time ~ U(0,1) for motion blur.
    """
    nx, S, g = cam.nx, count, cam.grid
    P = px.shape[0] if hasattr(px, "shape") else len(px)
    pos = np.asarray(cam.pos, np.float32)
    right = np.asarray(cam.right, np.float32)
    up = np.asarray(cam.up, np.float32)
    gaze = np.asarray(cam.gaze, np.float32)

    pw = (cam.right_edge - cam.left) / nx
    ph = (cam.top - cam.bottom) / cam.ny
    sw, sh = pw / g, ph / g

    # pixel lower-bottom corners (PixelLBCorner, src/Camera.cpp:84-92)
    ub = (cam.left + px * pw)[:, None]                      # [P, 1]
    vb = (cam.top - (py + 1) * ph)[:, None]

    s = base + jnp.arange(S)
    si = (s % g).astype(jnp.float32)                        # [S]
    sj = (s // g).astype(jnp.float32)

    chi = jax.random.uniform(key, (5, P, S))
    ju = ub + (si[None, :] + chi[0]) * sw                   # [P, S]
    jv = vb + (sj[None, :] + chi[1]) * sh
    m = Vec3(pos[0] + gaze[0] * cam.near_distance + ju * right[0] + jv * up[0],
             pos[1] + gaze[1] * cam.near_distance + ju * right[1] + jv * up[1],
             pos[2] + gaze[2] * cam.near_distance + ju * right[2] + jv * up[2])
    posv = Vec3(pos[0], pos[1], pos[2])
    d = vnormalize(m - posv)                                # [P, S] x3

    if cam.is_dof:
        lu = cam.aperture_size * (chi[2] - 0.5)
        lv = cam.aperture_size * (chi[3] - 0.5)
        q = Vec3(pos[0] + lu * right[0] + lv * up[0],
                 pos[1] + lu * right[1] + lv * up[1],
                 pos[2] + lu * right[2] + lv * up[2])
        gz = Vec3(gaze[0], gaze[1], gaze[2])
        t_fd = cam.focus_distance / vdot(d, gz)
        p = posv + d * t_fd
        d = vnormalize(p - q)
        o = q
        time = jnp.zeros((P, S))
    else:
        o = Vec3(jnp.broadcast_to(pos[0], d.shape),
                 jnp.broadcast_to(pos[1], d.shape),
                 jnp.broadcast_to(pos[2], d.shape))
        time = chi[4]

    n = P * S
    flat = lambda a: a.reshape(n)
    return Rays(o=Vec3(flat(o.x), flat(o.y), flat(o.z)),
                d=Vec3(flat(d.x), flat(d.y), flat(d.z)),
                time=time.reshape(n))


def sample_rays_range(cam: Camera, key: jax.Array, base, count: int,
                      row0=0, n_rows: int | None = None) -> Rays:
    """Jittered sample rays in image-row-major lane order (see
    sample_rays_at; this wrapper keeps the historical bit-stream: the chi
    draw over [P, S] lanes equals the old [ny, nx, S] draw flattened)."""
    nx = cam.nx
    ny = cam.ny if n_rows is None else n_rows
    px = jnp.broadcast_to(jnp.arange(nx)[None, :], (ny, nx)).reshape(-1)
    py = row0 + jnp.broadcast_to(jnp.arange(ny)[:, None],
                                 (ny, nx)).reshape(-1)
    return sample_rays_at(cam, key, px, py, base, count)
