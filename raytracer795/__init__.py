"""raytracer795 — a differentiable ray tracer in JAX/XLA/Pallas.

A from-scratch reimplementation of the capability set of the reference C++
renderer badiba/raytracer-795 (CENG 795 coursework ray tracer), redesigned
for an accelerator:

- scenes are pytrees of device arrays (SoA), not object graphs;
- rays are wavefront batches shaped [N] / [H, W, S], not per-pixel recursion;
- the Whitted integrator is an iterative masked-lane machine, the path tracer
  a bounce loop with throughput and NEE;
- BVH traversal is a stackless walk over a flattened node array: a
  per-ray Pallas kernel on the GPU, a vectorized jnp walk elsewhere;
- multi-device scaling uses jax.sharding meshes + shard_map, not threads.

Reference behavior contracts are cited per module as ``src/<file>:<lines>``
(paths into the reference repo).
"""

import jax as _jax

# Ray-geometry math must stay full float32: never let a float32 matmul
# fall to TF32 on the GPU's tensor cores.
_jax.config.update("jax_default_matmul_precision", "float32")

from raytracer795.scene.loader import load_scene
from raytracer795.render import render_scene, render_camera

__version__ = "0.1.0"

__all__ = [
    "load_scene",
    "render_scene",
    "render_camera",
]
