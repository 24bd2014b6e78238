"""Path-tracer correctness: analytic values and estimator consistency.

The reference's hw7 path tracer exists only as documentation
(pages/Page7.md), so there is no golden binary to diff against. Instead:
- a furnace test with a closed-form answer validates radiometric scaling;
- a floor-point direct-lighting value is checked against an independent
  numpy Monte Carlo integral;
- uniform / cosine-importance / NEE / RR estimators must agree with each
  other (unbiasedness — any pdf mistake breaks this).
"""

import re

import numpy as np
import pytest

from tests.conftest import SCENES, load


def _render(name, spp, seed=0):
    from raytracer795.render import render_camera

    return render_camera(load(name), 0, spp=spp, seed=seed)


def _render_variant(tmp_path, name, spp, params=None, depth=None, seed=0):
    from raytracer795.render import render_camera
    from raytracer795.scene.loader import load_scene

    src = open(f"{SCENES}/{name}.xml").read()
    if params is not None:
        src = re.sub(r"<RendererParams>.*</RendererParams>",
                     f"<RendererParams>{params}</RendererParams>", src)
    if depth is not None:
        src = re.sub(r"<MaxRecursionDepth>\d+</MaxRecursionDepth>",
                     f"<MaxRecursionDepth>{depth}</MaxRecursionDepth>", src)
    p = tmp_path / f"{name}_variant.xml"
    p.write_text(src)
    return render_camera(load_scene(str(p)), 0, spp=spp, seed=seed)


class TestFurnace:
    def test_closed_form(self):
        """Diffuse sphere (albedo 0.5) inside constant emission 2 env:
        surface radiance = albedo * L = 1; background = L = 2.

        Asserted on the mean of an 8x8 on-sphere pixel block: the per-lane
        NEE estimator of the enclosing sphere light has std ~1.3, so a
        single 64-spp pixel carries SE ~0.16 — a block x 256 spp brings the
        SE to ~0.01 (tolerance is 4 sigma)."""
        img = _render("furnace", spp=256)
        block = img[12:20, 12:20].mean(axis=(0, 1))
        assert np.allclose(block, 0.5 * 2.0, rtol=0.04), block
        corner = img[1, 1]             # direct env hit
        assert np.allclose(corner, 2.0, rtol=0.02), corner


class TestDirectValue:
    def test_nee_matches_numpy_integral(self, tmp_path):
        """Floor point under the ceiling light: NEE at depth 1 equals an
        independent Monte Carlo area integral of L * (kd/pi) * G."""
        img = _render_variant(tmp_path, "cornellbox_pt", spp=128, depth=1)
        # independent estimate at the pixel [60,50] floor point
        rng = np.random.default_rng(0)
        cam = np.array([0, 1, 3.8])
        v = 1 - (60.5 / 100) * 2
        d = np.array([0, v, -1.0])
        d /= np.linalg.norm(d)
        p = cam + ((0 - cam[1]) / d[1]) * d
        M = 200000
        lp = np.stack([rng.uniform(-0.6, 0.6, M), np.full(M, 1.999),
                       rng.uniform(-0.6, 0.2, M)], 1)
        to_l = lp - p
        d2 = (to_l ** 2).sum(1)
        wi = to_l / np.sqrt(d2)[:, None]
        geom = np.maximum(0, wi[:, 1]) * np.abs(wi[:, 1]) / d2
        expected = np.array([18, 17, 14.0]) * (0.7 / np.pi) * geom.mean() * 0.96
        got = img[60, 50]
        assert np.allclose(got, expected, rtol=0.15), (got, expected)


@pytest.mark.slow
class TestEstimatorConsistency:
    def test_all_estimators_agree(self, tmp_path):
        imgs = {}
        for name, params in [
            ("nee", "NextEventEstimation ImportanceSampling"),
            ("brute", "ImportanceSampling"),
            ("uniform", ""),
            ("rr", "NextEventEstimation ImportanceSampling RussianRoulette"),
        ]:
            imgs[name] = _render_variant(tmp_path, "cornellbox_pt",
                                         spp=96, params=params, seed=5)
        ref = imgs["nee"].mean()
        for other in ("brute", "uniform", "rr"):
            d = abs(imgs["nee"].mean(axis=(0, 1))
                    - imgs[other].mean(axis=(0, 1))).mean()
            assert d / ref < 0.05, (other, d / ref)
