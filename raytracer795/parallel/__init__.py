from raytracer795.parallel.shard import (  # noqa: F401
    RAY_AXIS, make_ray_mesh, render_rays_sharded, train_step,
    differentiable_params, scene_with_params)
