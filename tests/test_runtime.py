"""Runtime subsystems: progressive film checkpoint/resume + tonemapping.

SURVEY §5: the reference writes the film only at the end of the render
(src/Scene.cpp:361) and its attempted global tonemapper shipped buggy
(pages/Page5.md:101); these are this framework's replacements.
"""

import numpy as np
import pytest

from tests.conftest import load


class TestCheckpointResume:
    def _render(self, loaded, tmp_path, abort_after=None, resume=False,
                spp=8):
        from raytracer795 import render as render_mod

        ckpt = render_mod.FilmCheckpoint(str(tmp_path / "film.ckpt.npz"),
                                         every_s=0.0)
        return render_mod.render_camera(
            loaded, 0, seed=3, spp=spp, checkpoint=ckpt,
            _abort_after_saves=abort_after)

    def test_kill_resume_bit_equal(self, tmp_path, monkeypatch):
        """Kill the renderer mid-render (after 3 chunk saves), resume, and
        the final image is bit-equal to an uninterrupted render."""
        from raytracer795 import render as render_mod

        loaded = load("cornellbox")
        # shrink the lane budget so a 32x32 x 8spp frame needs 2 row bands
        # x 4 sample chunks (band and chunk resume paths both exercised)
        import dataclasses
        loaded.cameras[0] = dataclasses.replace(
            loaded.cameras[0], nx=32, ny=32)
        monkeypatch.setattr(render_mod, "MAX_LANES", 32 * 16 * 2)

        reference = render_mod.render_camera(loaded, 0, seed=3, spp=8)

        with pytest.raises(KeyboardInterrupt):
            self._render(loaded, tmp_path, abort_after=3)
        assert (tmp_path / "film.ckpt.npz").exists()
        assert (tmp_path / "film.ckpt.npz.preview.png").exists()

        resumed = self._render(loaded, tmp_path)
        np.testing.assert_array_equal(np.asarray(resumed),
                                      np.asarray(reference))

    def test_mismatched_checkpoint_ignored(self, tmp_path, monkeypatch):
        """A checkpoint from a different (seed/spp/camera) render is not
        resumed from."""
        from raytracer795 import render as render_mod
        import dataclasses

        loaded = load("cornellbox")
        loaded.cameras[0] = dataclasses.replace(
            loaded.cameras[0], nx=32, ny=32)
        monkeypatch.setattr(render_mod, "MAX_LANES", 32 * 16 * 2)

        with pytest.raises(KeyboardInterrupt):
            self._render(loaded, tmp_path, abort_after=1, spp=8)
        # different spp -> state key mismatch -> fresh render, still correct
        img4 = self._render(loaded, tmp_path, spp=4)
        ref4 = render_mod.render_camera(loaded, 0, seed=3, spp=4)
        np.testing.assert_array_equal(np.asarray(img4), np.asarray(ref4))


class TestTonemap:
    def test_reinhard_properties(self):
        from raytracer795.utils.tonemap import reinhard_global

        rng = np.random.default_rng(0)
        hdr = rng.lognormal(2.0, 2.0, (32, 32, 3)).astype(np.float32)
        out = reinhard_global(hdr)
        assert out.shape == hdr.shape
        assert out.min() >= 0.0 and out.max() <= 255.0
        # burnout: the brightest pixels reach (near) white
        assert out.max() > 250.0
        # gray ramp maps monotonically
        ramp = np.linspace(0.01, 100.0, 64, dtype=np.float32)
        gray = np.repeat(ramp, 3).reshape(1, 64, 3)
        lum_out = reinhard_global(gray)[0, :, 0]
        assert (np.diff(lum_out) >= -1e-4).all()
        # black stays black (the reference's bug: dark pixels brightened)
        hdr[0, 0] = 0.0
        assert (reinhard_global(hdr)[0, 0] == 0).all()

    def test_scene_tonemap_element(self, tmp_path):
        """<Tonemap> under Camera parses and applies to the LDR output."""
        import re

        from raytracer795 import render as render_mod
        from raytracer795.scene.loader import load_scene
        from tests.conftest import SCENES

        import shutil
        shutil.copy(f"{SCENES}/sky.exr", tmp_path / "sky.exr")
        src = open(f"{SCENES}/envlight.xml").read()
        src = src.replace(
            "</ImageName>",
            "</ImageName><Tonemap><TMO>Photographic</TMO>"
            "<TMOOptions>0.18 1</TMOOptions><Saturation>1.0</Saturation>"
            "<Gamma>2.2</Gamma></Tonemap>", 1)
        p = tmp_path / "envlight_tm.xml"
        p.write_text(src)
        loaded = load_scene(str(p))
        assert loaded.cameras[0].tonemap == (0.18, 1.0, 1.0, 2.2)

        paths = render_mod.render_scene(loaded, out_dir=str(tmp_path),
                                        seed=0, spp=1)
        from PIL import Image
        out = np.asarray(Image.open(paths[0])).astype(np.float32)
        # raw envlight radiance blows past 255 everywhere the sun reflects;
        # the tonemapped image must be in range and non-degenerate
        assert out.max() <= 255 and out.std() > 1.0

class TestLdrDevicePath:
    """ldr=True quantizes on device (u8 transfer); must be bitwise what
    to_ldr() of the float film produces — same radiance program, same
    clip/convert semantics ((unsigned char) cast, src/Image.cpp:64-69)."""

    def test_ldr_equals_float_1spp_banded(self, monkeypatch):
        import dataclasses

        from raytracer795 import render as render_mod
        from raytracer795.utils.image_io import to_ldr

        loaded = load("cornellbox")
        loaded.cameras[0] = dataclasses.replace(
            loaded.cameras[0], nx=32, ny=32)
        # force 2 row bands so the banded 1-spp LDR path runs too
        monkeypatch.setattr(render_mod, "MAX_LANES", 32 * 16)
        f = render_mod.render_camera(loaded, 0, seed=1, spp=1)
        u = render_mod.render_camera(loaded, 0, seed=1, spp=1, ldr=True)
        assert u.dtype == np.uint8
        np.testing.assert_array_equal(u, to_ldr(f))

    def test_ldr_equals_float_multisample(self, monkeypatch):
        import dataclasses

        from raytracer795 import render as render_mod
        from raytracer795.utils.image_io import to_ldr

        loaded = load("cornellbox")
        loaded.cameras[0] = dataclasses.replace(
            loaded.cameras[0], nx=32, ny=32)
        monkeypatch.setattr(render_mod, "MAX_LANES", 32 * 16 * 2)
        f = render_mod.render_camera(loaded, 0, seed=2, spp=4)
        u = render_mod.render_camera(loaded, 0, seed=2, spp=4, ldr=True)
        assert u.dtype == np.uint8
        np.testing.assert_array_equal(u, to_ldr(f))
