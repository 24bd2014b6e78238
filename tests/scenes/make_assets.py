"""Generate the HDR test assets (committed for provenance).

sky.exr — lat-long environment map: blue-to-white sky gradient with a bright
warm "sun" disc. Written ZIP-compressed by utils/exr.write_exr; the golden
render is produced by the reference renderer whose tinyexr reads this very
file — an independent implementation validating the ZIP codec end to end.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
from raytracer795.utils import exr  # noqa: E402

here = os.path.dirname(os.path.abspath(__file__))


def make_sky_exr():
    H, W = 64, 128
    v = np.linspace(0.0, 1.0, H)[:, None]       # 0 = zenith, 1 = nadir
    u = np.linspace(0.0, 1.0, W)[None, :]
    sky_top = np.array([14.0, 22.0, 48.0])
    sky_bot = np.array([36.0, 34.0, 32.0])
    img = (sky_top[None, None] * (1 - v[..., None])
           + sky_bot[None, None] * v[..., None])
    # warm sun disc at u=0.25, v=0.3
    du = (u - 0.25)
    dv = (v - 0.3)
    sun = np.exp(-((du / 0.03) ** 2 + (dv / 0.06) ** 2))
    img = img + sun[..., None] * np.array([2400.0, 1800.0, 1000.0])[None, None]
    img = img.astype(np.float32)
    exr.write_exr(os.path.join(here, "sky.exr"), img, compression="zip")
    print("wrote sky.exr", img.shape, "max", img.max())


# ---------------------------------------------------------------------------
# rock100k.ply — dragon-scale procedural mesh (~101k triangles).
#
# The reference's flagship acceleration result is a 1.8M-triangle dragon
# (pages/Page2.md:57); no large asset ships with either repo, so the
# BVH-at-scale golden uses this deterministic displaced sphere ("rock"):
# a (320 x 160) lat-long grid with a multi-frequency sinusoidal radius,
# written as binary_little_endian PLY (exercising scene/ply.py's binary
# path at scale). Regenerate with: python tests/scenes/make_assets.py
# ---------------------------------------------------------------------------

def make_rock_ply(path, nu=320, nv=160):
    uu = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    R = (1.0 + 0.14 * np.sin(6 * U) * np.sin(5 * V)
         + 0.07 * np.sin(13 * U + 1.0) * np.sin(11 * V + 2.0)
         + 0.035 * np.sin(27 * U + 3.0) * np.sin(23 * V))
    verts = np.stack([(R * np.sin(V) * np.cos(U)).ravel(),
                      (R * np.cos(V)).ravel(),
                      (R * np.sin(V) * np.sin(U)).ravel()],
                     axis=1).astype("<f4")

    # quad grid -> 2 triangles each (vectorized: 1.8M faces in ms)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a = (i % nu) * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1)
    d = (i % nu) * nv + (j + 1)
    f1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    f2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    faces = np.empty((f1.shape[0] * 2, 3), "<i4")
    faces[0::2] = f1
    faces[1::2] = f2

    rec = np.zeros(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    rec["n"] = 3
    rec["v"] = faces
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(verts))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face %d\n" % len(faces))
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(verts.tobytes())
        f.write(rec.tobytes())
    return len(verts), len(faces)


def ensure_rock(path: str, nu: int, nv: int) -> str:
    """Generate a procedural rock PLY on demand (deterministic).

    rock100k.ply (320x160) is committed; the dragon-scale rock1800k.ply
    (1350x668 -> 1,800,900 triangles, ~34 MB — the scale of the reference's
    flagship dragon, pages/Page2.md:57) is generated here on first use
    instead of being committed.
    """
    if not os.path.exists(path):
        make_rock_ply(path, nu=nu, nv=nv)
    return path


if __name__ == "__main__":
    make_sky_exr()
    nverts, nfaces = make_rock_ply(os.path.join(here, "rock100k.ply"))
    print("wrote rock100k.ply:", nverts, "verts,", nfaces, "tris")
    nverts, nfaces = make_rock_ply(os.path.join(here, "rock1800k.ply"),
                                   nu=1350, nv=668)
    print("wrote rock1800k.ply:", nverts, "verts,", nfaces, "tris")
