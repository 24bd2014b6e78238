"""Test harness configuration.

Pins JAX to an 8-virtual-device CPU mesh BEFORE any backend initializes, so
the suite is deterministic and runs anywhere.

GPU: ``RT795_GPU_TESTS=1 python -m pytest tests -m gpu -q`` keeps the GPU
backend and runs the ``gpu``-marked subset (compiled-kernel goldens,
kernel-vs-reference gradients) on the card. A fixture below skips those
tests, with a reason, on any other backend; nothing is decided at import.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

GPU_TESTS = os.environ.get("RT795_GPU_TESTS") == "1"
# CPU suite runs are XLA-COMPILE-bound (big unrolled render/backward
# programs on a few cores); backend optimization level 0 roughly halves
# compile time. GPU runs keep full optimization.
if not GPU_TESTS and "xla_backend_optimization_level" \
        not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"

import jax  # noqa: E402

if not GPU_TESTS:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raytracer795.utils import compile_cache  # noqa: E402

compile_cache.configure()

SCENES = os.path.join(os.path.dirname(__file__), "scenes")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """``gpu``-marked tests need the compiled kernels on a real card."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU backend, have {jax.default_backend()!r} "
                    "(run RT795_GPU_TESTS=1 pytest -m gpu on the card)")


@pytest.fixture(scope="session")
def scene_dir():
    return SCENES


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDENS


def load(name):
    from raytracer795.scene.loader import load_scene

    return load_scene(os.path.join(SCENES, name + ".xml"))


def golden(name):
    from raytracer795.utils.image_io import read_ppm

    return read_ppm(os.path.join(GOLDENS, name + ".ppm"))


def ldr(img):
    from raytracer795.utils.image_io import to_ldr

    return to_ldr(np.asarray(img)).astype(np.float32)
