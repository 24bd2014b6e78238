"""The program's surroundings: compile cache, PNG codec, device checks.

These run on the CPU and need no card: where the compile cache goes, the
standard-library PNG codec that replaces an image package, how processes
share a GPU host, and that the on-card smoke test and the benches refuse to
run without a GPU instead of measuring the CPU.
"""

import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

import conftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, nothing else is
    set."""
    import jax

    from raytracer795.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Unset: <checkout>/.jax_cache, a fixed path listed in .gitignore."""
    import jax

    from raytracer795.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_png_round_trip(tmp_path):
    """write_png stores the clamped, truncated LDR image; read_png gives
    it back exactly; save_image dispatches .png to it."""
    from raytracer795.utils import image_io

    img = np.random.default_rng(0).uniform(-20, 300, (37, 53, 3))
    path = str(tmp_path / "x.png")
    image_io.save_image(path, img.astype(np.float32))
    back = image_io.read_png(path)
    assert back.dtype == np.uint8 and back.shape == (37, 53, 3)
    np.testing.assert_array_equal(back, image_io.to_ldr(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_bytes(px, ctype, filters, palette=None):
    """Encode ``px`` [H, W*C] uint8 with the given per-row filter types."""
    from raytracer795.utils import image_io

    h, stride = px.shape
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    x = px.astype(np.int64)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[y, :-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
                4: _paeth(left, up, upleft)}[filters[y % len(filters)]]
        rows.append(bytes([filters[y % len(filters)]])
                    + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    w = stride // bpp
    out = (b"\x89PNG\r\n\x1a\n" + image_io._png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
    if palette is not None:
        out += image_io._png_chunk(b"PLTE", palette.tobytes())
    return (out + image_io._png_chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + image_io._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [2, 6, 0, 4, 3])
def test_png_decode_filters_and_colour_types(ctype, tmp_path):
    """All five row filters, and gray / gray+alpha / palette / RGBA
    expanded to RGB the way an image library's RGB conversion does."""
    from raytracer795.utils import image_io

    rng = np.random.default_rng(ctype)
    h, w = 11, 9
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
        px = px % 16
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(px.reshape(h, w * ch), ctype,
                                [0, 1, 2, 3, 4], palette))
    got = image_io.read_png(str(path))
    if ctype == 3:
        want = palette[px[..., 0]]
    elif ch <= 2:
        want = np.repeat(px[..., :1], 3, axis=-1)
    else:
        want = px[..., :3]
    np.testing.assert_array_equal(got, want)


def test_png_textures_decode_without_image_package():
    """The scenes' PNG textures load through the in-repo codec, and the
    PNG copy of gradient.jpg holds 8-bit RGB pixels of the same size."""
    from raytracer795.scene import loader
    from raytracer795.utils import image_io

    for name in ("bump.png", "checker.png", "normalmap.png",
                 "gradient.png"):
        img = loader._load_image(os.path.join(conftest.SCENES, name))
        assert img.dtype == np.float32 and img.shape[-1] == 3
        assert 0 <= img.min() and img.max() <= 255
    assert image_io.read_png(os.path.join(
        conftest.SCENES, "gradient.png")).shape == (48, 96, 3)


def _captured_initialize(monkeypatch):
    """Run distributed.initialize against a stand-in jax.distributed and
    return what it was asked for."""
    import jax

    got = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: got.update(kw))
    monkeypatch.setattr(jax, "process_index",
                        lambda: got.get("process_id", 0))
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "JAX_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(var, raising=False)
    return got


@pytest.mark.parametrize("env,kwargs,want", [
    # one process per host, the CLI's documented launch: every local card
    ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, {}, None),
    ({"JAX_NUM_PROCESSES": "8", "JAX_PROCESS_ID": "7"}, {}, None),
    # processes sharing a host are given their cards by the launch
    ({"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3",
      "JAX_LOCAL_DEVICE_IDS": "2,3"}, {}, [2, 3]),
    ({"JAX_LOCAL_DEVICE_IDS": "0"},
     {"num_processes": 2, "process_id": 0, "local_device_ids": [1]}, [1]),
])
def test_initialize_local_devices(monkeypatch, env, kwargs, want):
    """Device ids reach jax.distributed only where the launch states them;
    otherwise a process opens every card of its host."""
    from raytracer795.parallel import distributed

    got = _captured_initialize(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pid = distributed.initialize(coordinator_address="localhost:1234",
                                 **kwargs)
    assert got["local_device_ids"] == want
    assert pid == got["process_id"]


def test_initialize_single_process_is_a_no_op(monkeypatch):
    from raytracer795.parallel import distributed

    got = _captured_initialize(monkeypatch)
    assert distributed.initialize() == 0
    assert got == {}


def test_card_refuses_a_missing_power_limit(monkeypatch):
    """A number is never printed without its card and power limit:
    without nvidia-smi's 'name, power.limit' line, card() raises."""
    import subprocess as sp

    from raytracer795.utils import device

    real_run = sp.run

    def fake(stdout, rc=0):
        return lambda *a, **k: sp.CompletedProcess(a, rc, stdout, "")

    monkeypatch.setattr(device.subprocess, "run",
                        fake("NVIDIA H100 80GB HBM3, 700.00 W\n"))
    assert device.card() == "NVIDIA H100 80GB HBM3, 700.00 W"
    for out, rc in (("", 0), ("No devices were found\n", 6),
                    ("NVIDIA H100 80GB HBM3, [N/A]\n", 0)):
        monkeypatch.setattr(device.subprocess, "run", fake(out, rc))
        with pytest.raises(RuntimeError, match="power.limit"):
            device.card()
    monkeypatch.setattr(device, "NVIDIA_SMI", ["/nonexistent/nvidia-smi"])
    monkeypatch.setattr(device.subprocess, "run", real_run)
    with pytest.raises(RuntimeError, match="nvidia-smi failed"):
        device.card()


def test_require_gpu_refuses_cpu():
    """Benches and the profiler never report a CPU number as a device
    number: without a GPU they exit."""
    from raytracer795.utils import device

    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu("bench")


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    """On the CPU the smoke test exits non-zero, names the missing GPU,
    and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = _run_smoke(REPO, env)
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the smoke
    test exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_smoke(str(tmp_path), env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
