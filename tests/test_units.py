"""Unit tests for pure functions against independently computed values."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer795.ops import perlin as perlin_ops
from raytracer795.scene import types as T
from raytracer795.utils import exr
from raytracer795.utils.vec3 import (Vec3, vnormalize, vorthonormal_u,
                                     vreflect, vscrub_nan)


class TestVec3:
    def test_normalize(self):
        v = Vec3.from_array(jnp.asarray([[3.0, 0.0, 4.0]]))
        assert np.allclose(np.asarray(vnormalize(v).to_array()),
                           [[0.6, 0, 0.8]])

    def test_orthonormal_u(self):
        # mirrors GeometryHelpers::GetOrthonormalUVector semantics
        # NOTE: vectors whose smallest-|component| equals 1 (e.g. (1,1,1))
        # degenerate to a zero cross in the reference too — not tested.
        for v in ([0.0, 1.0, 0.0], [0.3, -0.9, 0.4], [-0.5, 2.0, 0.8]):
            vv = Vec3.from_array(jnp.asarray([v]))
            u = np.asarray(vorthonormal_u(vv).to_array())[0]
            assert abs(u @ np.asarray(v)) < 1e-5
            assert abs(np.linalg.norm(u) - 1) < 1e-5

    def test_reflect(self):
        d = Vec3.from_array(jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2))
        n = Vec3.from_array(jnp.asarray([[0.0, 1.0, 0.0]]))
        r = np.asarray(vreflect(d, n).to_array())[0]
        assert np.allclose(r, [1 / np.sqrt(2), 1 / np.sqrt(2), 0], atol=1e-6)

    def test_scrub_nan(self):
        v = Vec3.from_array(jnp.asarray([[1.0, jnp.nan, 2.0],
                                         [1.0, 2.0, 3.0]]))
        out = np.asarray(vscrub_nan(v).to_array())
        assert np.all(out[0] == 0) and np.all(out[1] == [1, 2, 3])


class TestPerlin:
    # Golden values generated by compiling the reference's Perlin.cpp
    # (exact tables/weights of src/Perlin.cpp:4-30) and evaluating.
    CASES = [
        ((0.3, 0.7, 1.9), (0.70418137, 0.00708523, -0.25417706)),
        ((-1.2, 0.4, 2.5), (0.48124471, 0.02522341, -0.38337252)),
        ((5.5, -3.3, 0.1), (0.44578764, 0.28901112, 0.12487239)),
        ((0.0, 0.0, 0.0), (0.5, 0.0, 0.0)),
        ((10.7, 8.2, -4.9), (0.53511977, 0.08775945, 0.37971580)),
    ]

    def test_values_match_reference(self):
        from raytracer795.utils.vec3 import Vec3

        for pt, (lin1, abs3, none2) in self.CASES:
            p = Vec3.from_array(jnp.asarray([pt], jnp.float32))
            assert np.asarray(perlin_ops.perlin(p, 1.0, T.NC_LINEAR))[0] == \
                pytest.approx(lin1, abs=2e-5)
            assert np.asarray(perlin_ops.perlin(p, 3.0, T.NC_ABSVAL))[0] == \
                pytest.approx(abs3, abs=2e-5)
            assert np.asarray(perlin_ops.perlin(p, 2.0, T.NC_NONE))[0] == \
                pytest.approx(none2, abs=2e-5)

    def test_gradient_matches_reference(self):
        from raytracer795.utils.vec3 import Vec3

        p = Vec3.from_array(jnp.asarray([(0.3, 0.7, 1.9)], jnp.float32))
        g = np.asarray(
            perlin_ops.perlin_gradient(p, 2.0, T.NC_LINEAR).to_array())[0]
        assert np.allclose(g, [0.482619, -0.478268, -0.570059], atol=2e-3)


class TestExr:
    def test_roundtrip(self, tmp_path):
        img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32) * 10
        path = str(tmp_path / "t.exr")
        exr.write_exr(path, img)
        back = exr.read_exr(path)
        # written as half floats
        assert np.allclose(back, img.astype(np.float16), rtol=1e-3)

    def test_reads_reference_tinyexr_output(self, golden_dir):
        """tests/goldens/envlight_hdr.exr was written by the REFERENCE
        renderer (tinyexr, NONE-compressed half B/G/R, src/Helper.cpp:361-412)
        — an externally-produced file our reader must parse."""
        img = exr.read_exr(golden_dir + "/envlight_hdr.exr")
        assert img.shape == (96, 96, 3)
        assert np.isfinite(img).all()
        # the sky gradient is blue-dominant away from the sun
        assert img[..., 2].mean() > img[..., 0].mean() > 0

    def test_zip_write_roundtrip(self, tmp_path):
        img = (np.random.default_rng(3).random((37, 23, 3)) * 50
               ).astype(np.float32)
        path = str(tmp_path / "z.exr")
        exr.write_exr(path, img, compression="zip")
        back = exr.read_exr(path)
        assert np.allclose(back, img.astype(np.float16), rtol=1e-3)

    def test_zip_read_external_truth(self, scene_dir):
        """tests/scenes/sky.exr is ZIP-compressed (written by our codec) and
        is read by the reference's tinyexr when producing the envlight
        golden — tinyexr accepting it validates the ZIP framing externally;
        here assert our own reader agrees with the generator's math."""
        img = exr.read_exr(scene_dir + "/sky.exr")
        assert img.shape == (64, 128, 3)
        # zenith row is the blue sky_top of make_assets.py
        assert np.allclose(img[0, 0], [14.0, 22.0, 48.0], rtol=2e-3)
        assert img.max() > 2000  # the sun disc


class TestPly:
    def test_ascii_quads_and_uv(self, scene_dir):
        from raytracer795.scene.ply import read_ply

        ply = read_ply(scene_dir + "/octa.ply")
        assert ply.vertices.shape == (8, 3)
        assert ply.uv is not None and ply.uv.shape == (8, 2)
        assert len(ply.faces) == 6 and all(len(f) == 4 for f in ply.faces)

    def test_binary_le(self, scene_dir):
        from raytracer795.scene.ply import read_ply

        ply = read_ply(scene_dir + "/octa_bin.ply")
        assert ply.vertices.shape == (6, 3)
        assert ply.uv is None
        assert len(ply.faces) == 8 and all(len(f) == 3 for f in ply.faces)


class TestImageIO:
    def test_ppm_roundtrip(self, tmp_path):
        from raytracer795.utils.image_io import read_ppm, write_ppm

        img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3) * 10
        path = str(tmp_path / "t.ppm")
        write_ppm(path, img)
        back = read_ppm(path)
        assert np.array_equal(back, np.clip(img, 0, 255).astype(np.uint8))


class TestLoader:
    def test_scene_defaults(self, tmp_path):
        # defaults per src/Parser.h:23-25
        xml = """<Scene><Cameras><Camera id="1">
            <Position>0 0 0</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
            <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
            <ImageResolution>4 4</ImageResolution><ImageName>x.png</ImageName>
            </Camera></Cameras>
            <Lights></Lights>
            <Materials><Material id="1">
            <AmbientReflectance>1 1 1</AmbientReflectance>
            <DiffuseReflectance>1 1 1</DiffuseReflectance>
            <SpecularReflectance>0 0 0</SpecularReflectance>
            </Material></Materials>
            <VertexData>0 0 -5</VertexData>
            <Objects><Sphere id="1"><Material>1</Material>
            <Center>1</Center><Radius>1</Radius></Sphere></Objects></Scene>"""
        p = tmp_path / "s.xml"
        p.write_text(xml)
        from raytracer795.scene.loader import load_scene

        loaded = load_scene(str(p))
        s = loaded.scene
        assert s.max_depth == 1
        assert float(s.shadow_eps) == pytest.approx(0.002)
        assert float(s.int_eps) == pytest.approx(0.001)
        assert s.groups[0].n_spheres == 1

    def test_camera_fovy_and_handedness(self, scene_dir):
        from raytracer795.scene.loader import load_scene

        loaded = load_scene(scene_dir + "/lights.xml")
        cam = loaded.cameras[0]
        assert cam.left_handed
        # FovY 50 at distance 1 -> top = tan(25 deg)
        assert cam.top == pytest.approx(np.tan(np.radians(25.0)), rel=1e-5)
        assert cam.right_edge == pytest.approx(cam.top * 200 / 150, rel=1e-5)

    def test_texture_parser_state_carries_over(self, scene_dir):
        """The reference's TextureMap parser reuses state across maps
        (variables declared outside the loop, src/Parser.h:480-486)."""
        from raytracer795.scene.loader import load_scene

        loaded = load_scene(scene_dir + "/textures.xml")
        texs = loaded.scene.textures
        # map 6 (perlin) inherits BumpFactor=2 set by map 5
        assert float(texs[5].bump_factor) == pytest.approx(2.0)
        # map 3 inherits Normalizer 255 from map 2
        assert float(texs[2].normalizer) == pytest.approx(255.0)

    def test_instance_matrix_composition(self, scene_dir):
        """resetTransform=false composes onto the base mesh's matrix
        (src/Helper.cpp:216-218)."""
        from raytracer795.scene.loader import load_scene

        loaded = load_scene(scene_dir + "/instances.xml")
        names = [g.name for g in loaded.scene.groups]
        assert any(n.startswith("instance#") for n in names)
