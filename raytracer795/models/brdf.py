"""The 8 analytic BRDF models, vectorized with per-lane selection.

Dispatch contract: Light::TermBRDF (src/Light.cpp:62-155); radiance
composition L * f * max(0, n.wi): Light::BRDF (src/Light.cpp:157-162).
All eight terms are computed for every lane and blended by brdf-type masks —
cheap elementwise work that avoids divergent control flow. All per-lane
vectors are lane-major Vec3 (utils/vec3.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from raytracer795.scene import types as T
from raytracer795.utils.vec3 import Vec3, vdot, vsafe_normalize, vwhere
from raytracer795.utils.vecmath import safe_div, safe_pow

_EPS = 1e-3  # Light::_epsilon (src/Light.h:16)


def _conductor_fresnel(n_t, k_t, d: Vec3, normal: Vec3):
    """Fresnel for conductors (src/Light.cpp:18-28); d = incoming direction.

    Denominators guarded: the lanes evaluating this with a non-conductor
    material row (n=k=0, grazing cos) would divide 0/0 and poison reverse
    mode through the downstream masks.
    """
    cos_t = -vdot(d, normal)
    two = 2.0 * n_t * cos_t
    cos2 = cos_t * cos_t
    nk2 = n_t * n_t + k_t * k_t
    rs = safe_div(nk2 - two + cos2, nk2 + two + cos2)
    rp = safe_div(nk2 * cos2 - two + 1.0, nk2 * cos2 + two + 1.0)
    return 0.5 * (rs + rp)


def _mat3_rows(tbl, idx) -> Vec3:
    """Gather [M, 3] material-table rows into lane components.

    ONE row gather (slice size 3) + column slices, instead of the three
    scalar-offset gathers that mixed advanced+scalar indexing
    (``tbl[idx, 0]``) lowers to.
    """
    rec = tbl[idx]
    return Vec3(rec[:, 0], rec[:, 1], rec[:, 2])


class BrdfRec(NamedTuple):
    """Per-lane gathered material rows for BRDF evaluation — gather ONCE
    per shading pass, evaluate per light (lights.py hoists this)."""

    kd: Vec3
    ks: Vec3
    p: Any          # [N] phong exponent
    btype: Any      # [N] int32 BRDF_*
    refr: Any       # [N] refraction index (TSF Fresnel)
    absidx: Any     # [N] absorption index


def gather_brdf_rec(mats, mat_idx) -> BrdfRec:
    return BrdfRec(kd=_mat3_rows(mats.diffuse, mat_idx),
                   ks=_mat3_rows(mats.specular, mat_idx),
                   p=mats.phong[mat_idx], btype=mats.brdf[mat_idx],
                   refr=mats.refraction[mat_idx],
                   absidx=mats.absorption_index[mat_idx])


def term_brdf(wi: Vec3, wo: Vec3, normal: Vec3, mats, mat_idx) -> Vec3:
    """f(wi, wo) per lane (Vec3); gathers rows itself (see term_brdf_rec)."""
    return term_brdf_rec(wi, wo, normal, gather_brdf_rec(mats, mat_idx))


def term_brdf_rec(wi: Vec3, wo: Vec3, normal: Vec3, rec: BrdfRec) -> Vec3:
    """f(wi, wo) per lane (Vec3) given pre-gathered material rows."""
    kd, ks, p, btype = rec.kd, rec.ks, rec.p, rec.btype

    n_wi = vdot(normal, wi)
    wr = vsafe_normalize(-wi + normal * (2.0 * n_wi))
    cos_r = jnp.maximum(0.0, vdot(wr, wo))          # Phong lobes
    h = vsafe_normalize(wo + wi)    # wi == -wo on dead lanes => |h| == 0
    cos_h = jnp.maximum(0.0, vdot(normal, h))       # Blinn lobes
    cos_i = jnp.maximum(0.0, vdot(wi, normal))
    pi = jnp.pi

    pow_r = safe_pow(cos_r, p)
    pow_h = safe_pow(cos_h, p)

    # Phong family (src/Light.cpp:63-93)
    f_mp = kd + ks * pow_r
    guard = cos_i >= _EPS
    inv_ci = 1.0 / jnp.maximum(cos_i, _EPS)
    f_op = vwhere(guard, kd + ks * (pow_r * inv_ci), 0.0)
    f_mpn = kd / pi + ks * (((p + 2.0) / (2.0 * pi)) * pow_r)

    # Blinn-Phong family (src/Light.cpp:94-121)
    f_mbp = kd + ks * pow_h
    f_obp = vwhere(guard, kd + ks * (pow_h * inv_ci), 0.0)
    f_mbpn = kd / pi + ks * (((p + 8.0) / (8.0 * pi)) * pow_h)

    # Torrance-Sparrow (src/Light.cpp:122-154)
    # cos_alpha clamped at 0: the reference raises it to an int exponent so
    # negative bases stay finite; float pow would NaN (only reachable when
    # n.wi <= 0, where the final cos term zeroes the lobe anyway).
    cos_alpha = jnp.maximum(0.0, vdot(h, normal))
    cos_theta = vdot(wi, normal)
    cos_phi = vdot(wo, normal)
    d_ts = ((p + 2.0) / (2.0 * pi)) * safe_pow(cos_alpha, p)  # DistributionTS
    g_left = safe_div(2.0 * vdot(normal, h) * vdot(normal, wo), vdot(wo, h))
    g_right = safe_div(2.0 * vdot(normal, h) * vdot(normal, wi), vdot(wi, h))
    g_ts = jnp.minimum(1.0, jnp.minimum(g_left, g_right))  # GeometryTS
    spec_ts = ks * safe_div(g_ts * d_ts, 4.0 * cos_phi * cos_theta)
    f_ts = kd / pi + spec_ts
    fr = _conductor_fresnel(rec.refr, rec.absidx, -wo, normal)
    f_tsf = (kd / pi) * (1.0 - fr) + spec_ts * fr

    out = f_mbp  # default arbitrary; every lane with a BRDF gets overwritten
    for code, f in ((T.BRDF_MP, f_mp), (T.BRDF_OP, f_op), (T.BRDF_MPN, f_mpn),
                    (T.BRDF_MBP, f_mbp), (T.BRDF_OBP, f_obp),
                    (T.BRDF_MBPN, f_mbpn), (T.BRDF_TS, f_ts),
                    (T.BRDF_TSF, f_tsf)):
        out = vwhere(btype == code, f, out)
    return out


def brdf_radiance(wi: Vec3, wo: Vec3, normal: Vec3, radiance: Vec3,
                  mats, mat_idx) -> Vec3:
    """L * f * max(0, n.wi) (src/Light.cpp:157-162)."""
    f = term_brdf(wi, wo, normal, mats, mat_idx)
    cos_i = jnp.maximum(0.0, vdot(wi, normal))
    return radiance * f * cos_i
