"""Scene data model: pytrees of SoA arrays.

The reference keeps an object graph behind a global ``pScene``
(src/Scene.h:54-129, src/defs.h:34). This design replaces it with a
single immutable pytree of arrays: every differentiable quantity (vertices,
material tables, light tables, texture images) is a jnp array leaf, while
structural facts (counts, decal modes, transform presence) are static metadata
so XLA specializes the render program per scene.

Index conventions: ALL indices stored here are 0-based (the XML contract is
1-based, src/Parser.h; the loader converts once at load time).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np

# --- enums (plain ints so they can live in static metadata) ---------------
# Material types (src/Material.h:7)
MAT_NORMAL, MAT_MIRROR, MAT_CONDUCTOR, MAT_DIELECTRIC = 0, 1, 2, 3
# BRDF types (src/Material.h:8)
BRDF_NONE, BRDF_OBP, BRDF_MBP, BRDF_MBPN, BRDF_OP, BRDF_MP, BRDF_MPN, BRDF_TS, BRDF_TSF = range(9)
# Decal modes (src/defs.h:8)
DECAL_REPLACE_KD, DECAL_BLEND_KD, DECAL_BUMP_NORMAL, DECAL_REPLACE_NORMAL, \
    DECAL_REPLACE_ALL, DECAL_REPLACE_BACKGROUND, DECAL_NONE = range(7)
# Interpolation (src/defs.h:9)
INTERP_NN, INTERP_BILINEAR = 0, 1
# Texture types (src/defs.h:10)
TEX_IMAGE, TEX_PERLIN = 0, 1
# Noise conversion (src/defs.h:11)
NC_ABSVAL, NC_LINEAR, NC_NONE = 0, 1, 2


def _dataclass_pytree(cls=None, *, meta: Tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree with the given static fields."""

    def wrap(c):
        c = dataclasses.dataclass(c)
        data_fields = [f.name for f in dataclasses.fields(c) if f.name not in meta]
        jax.tree_util.register_dataclass(c, data_fields, list(meta))
        return c

    return wrap(cls) if cls is not None else wrap


@_dataclass_pytree
class Materials:
    """SoA material table; one row per material id (src/Material.h:10-33).

    These arrays are the primary differentiable parameters of the framework.
    """

    ambient: Any        # [M, 3]
    diffuse: Any        # [M, 3]
    specular: Any       # [M, 3]
    mirror: Any         # [M, 3]
    phong: Any          # [M]   float (exponent; parsed as int, used in pow)
    refraction: Any     # [M]
    absorption_index: Any   # [M]
    absorption_coef: Any    # [M, 3]
    roughness: Any      # [M]
    is_rough: Any       # [M]  bool
    mtype: Any          # [M]  int32 (MAT_*)
    brdf: Any           # [M]  int32 (BRDF_*)


@_dataclass_pytree
class Lights:
    """SoA light tables per type (src/Light.h, src/Parser.h:1197-1315)."""

    ambient: Any        # [3]
    point_pos: Any      # [P, 3]
    point_intensity: Any    # [P, 3]
    dir_dir: Any        # [D, 3]  normalized
    dir_radiance: Any   # [D, 3]
    spot_pos: Any       # [S, 3]
    spot_dir: Any       # [S, 3]  normalized
    spot_intensity: Any  # [S, 3]
    spot_coverage: Any  # [S]  half-angle, radians (src/Light.cpp:332)
    spot_falloff: Any   # [S]  half-angle, radians
    area_pos: Any       # [A, 3]
    area_normal: Any    # [A, 3]  normalized
    area_u: Any         # [A, 3]  orthonormal frame (src/Light.cpp:450-451)
    area_v: Any         # [A, 3]
    area_radiance: Any  # [A, 3]
    area_size: Any      # [A]


@_dataclass_pytree(meta=("decal", "interp", "ttype", "nc"))
class Texture:
    """One texture map: image array + static sampling/decal parameters.

    Matches src/Texture.h:13-51. ``image`` is the decoded pixel array
    [H, W, 3] float32 in the source value range (LDR images keep 0..255 like
    the reference's byte buffers; EXR keeps float radiance). For Perlin
    textures ``image`` is a dummy [1,1,3] array (the noise needs no storage).
    """

    image: Any          # [H, W, 3] f32
    normalizer: Any     # scalar f32 (division at shading, src/Light.cpp:213)
    bump_factor: Any    # scalar f32
    noise_scale: Any    # scalar f32 (Perlin)
    decal: int          # DECAL_*
    interp: int         # INTERP_*
    ttype: int          # TEX_*
    nc: int             # NC_*


@_dataclass_pytree(meta=("max_leaf",))
class FlatBVH:
    """DFS-ordered flat BVH with skip links (built by ops/bvh.py).

    Stackless traversal: hit inner node i -> i+1; otherwise -> miss[i];
    leaves test primitive rows [first, first+count), count <= max_leaf.
    The group's primitive SoA is stored in leaf-contiguous (permuted) order.
    """

    bmin: Any       # [N, 3] f32
    bmax: Any       # [N, 3] f32
    first: Any      # [N] i32 (leaves; 0 for inner)
    count: Any      # [N] i32 (0 = inner node)
    miss: Any       # [N] i32 skip link; == N means traversal done
    max_leaf: int


@_dataclass_pytree(meta=("name", "has_xform", "n_tris", "n_spheres",
                         "has_blur", "bvh_share"))
class TraceGroup:
    """One intersectable unit: a set of primitives sharing one transform.

    The reference dispatches per object/instance with per-object matrices and
    per-object BVHs (src/Helper.cpp:18-80). Here untransformed, unblurred
    objects are merged into one group at load time so the wavefront
    intersector runs a minimal number of vectorized passes; transformed
    objects and instances keep their own group. Instances alias the base
    mesh's primitive arrays (same jnp arrays, zero copy) with their own
    matrices and material override (src/Instance.h:9-26, src/Helper.cpp:53-73).
    """

    # triangles
    tri_vidx: Any       # [T, 3] int32 into Scene.vertices
    tri_uvoff: Any      # [T] int32: uv row = vidx + uvoff (textureOffset -
    #                     vertexOffset contract, src/Parser.h:1102,1147)
    tri_smooth: Any     # [T] bool
    tri_mat: Any        # [T] int32
    tri_tex0: Any       # [T] int32 (-1 = none)
    tri_tex1: Any       # [T] int32
    # spheres
    sph_cidx: Any       # [S] int32 center vertex index
    sph_radius: Any     # [S] f32
    sph_mat: Any        # [S] int32
    sph_tex0: Any       # [S] int32
    sph_tex1: Any       # [S] int32
    # emission (object lights, pages/Page7.md:7-13): zero for non-lights
    tri_emis: Any       # [T, 3] f32
    sph_emis: Any       # [S, 3] f32
    # per-source-object root bounding boxes, local space. The reference only
    # bbox-tests INNER BVH nodes, so an object whose BVH is a single leaf
    # (1 primitive) never gets a bbox test (src/BVH.cpp:64-74,148-176);
    # such prims carry obj slot -1. Multi-prim objects are clipped by their
    # root bbox exactly like the reference's slab test (src/BVH.cpp:212-266).
    obj_bbox: Any       # [O, 2, 3] f32 (min, max)
    tri_obj: Any        # [T] int32 slot into obj_bbox, -1 exempt
    sph_obj: Any        # [S] int32
    # transform (identity when has_xform is False; arrays kept for pytree
    # structure stability)
    minv: Any           # [4, 4] world->local
    minv_t: Any         # [4, 4] inverse-transpose (normals)
    blur: Any           # [3] motion-blur translation per unit time
    # static metadata. Instance material overrides are baked into tri_mat at
    # load time (the runtime analogue of src/Helper.cpp:53-73's matIndex).
    name: str
    has_xform: bool
    n_tris: int
    n_spheres: int
    # static: True iff blur is nonzero (lets compiled programs skip the
    # per-lane motion-blur origin offset and transform gathers entirely)
    has_blur: bool = False

    # --- optional flat BVH over this group's triangles --------------------
    # Built at load time (ops/bvh.py) for large groups; None => linear scan.
    # When present, the tri_* arrays above are in leaf-contiguous order.
    bvh: Any = None         # FlatBVH | None
    # static: groups with the SAME nonnegative id share one BVH and one
    # triangle order (instances of one base mesh). The wavefront dispatch
    # batches such groups into ONE traversal launch (ops/intersect.py) —
    # the reference's per-instance loop (src/Helper.cpp:53-73) would cost
    # one kernel launch per instance per wavefront otherwise.
    bvh_share: int = -1


@_dataclass_pytree(meta=("has_xform",))
class SphereLight:
    """Emissive sphere for NEE area sampling (pages/Page7.md:7-13).

    Sampling: uniform point on the LOCAL unit sphere scaled by radius; the
    world-space area pdf uses the surface Jacobian |cof(M) n| so transformed
    (ellipsoid) lights stay unbiased.
    """

    center: Any     # [3] local-space center
    radius: Any     # scalar
    radiance: Any   # [3]
    m: Any          # [4, 4] local -> world
    cof: Any        # [3, 3] cofactor matrix det(M) M^-T (area Jacobian)
    has_xform: bool


@_dataclass_pytree
class MeshLight:
    """Emissive mesh: world-space triangles with an area CDF."""

    a: Any          # [T, 3]
    b: Any          # [T, 3]
    c: Any          # [T, 3]
    normal: Any     # [T, 3] unit geometric normals
    radiance: Any   # [3]
    cdf: Any        # [T] normalized cumulative areas
    total_area: Any  # scalar


@dataclasses.dataclass
class Camera:
    """Host-side camera description (static per compile).

    Basis construction and sampling contract: src/Camera.cpp:7-139.
    """

    cam_id: int
    image_name: str
    pos: np.ndarray         # [3]
    gaze: np.ndarray        # [3] normalized
    up: np.ndarray          # [3] orthonormalized
    right: np.ndarray       # [3]
    near_distance: float
    left: float
    right_edge: float
    bottom: float
    top: float
    nx: int
    ny: int
    num_samples: int        # total requested samples (MultiSample loop count)
    grid: int               # per-axis jitter grid = ceil-sqrt (Camera.cpp:21-28)
    focus_distance: float
    aperture_size: float
    is_dof: bool
    left_handed: bool
    # optional global TMO (key, burn_percent, saturation, gamma) applied to
    # LDR outputs — the reference's attempted hw5 feature (Page5.md §5.1.f)
    tonemap: tuple = None


@_dataclass_pytree(meta=(
    "max_depth", "bg_texture", "env_texture", "n_textures", "texture_statics",
    "renderer", "pt_nee", "pt_importance", "pt_rr", "any_dielectric",
    "any_brdf", "any_conductor", "any_rough",
))
class Scene:
    """The whole scene as a pytree (device side) + static structure."""

    vertices: Any       # [V, 3] f32
    texcoords: Any      # [TC, 2] f32 (>=1 row; padded)
    materials: Materials
    lights: Lights
    textures: Tuple[Texture, ...]
    groups: Tuple[TraceGroup, ...]
    background: Any     # [3] f32
    shadow_eps: Any     # scalar f32 (default .002, src/Parser.h:24)
    int_eps: Any        # scalar f32 (default .001, src/Parser.h:25)
    sphere_lights: Tuple = ()
    mesh_lights: Tuple = ()
    # static
    renderer: str = "whitted"   # "whitted" | "pathtracing"
    pt_nee: bool = False        # NextEventEstimation
    pt_importance: bool = False  # ImportanceSampling (cosine)
    pt_rr: bool = False         # RussianRoulette (throughput method)
    max_depth: int = 1  # default 1 (src/Parser.h:23)
    # True iff any material is dielectric: bounds the Whitted iteration count
    # (dielectrics split the lane's ray tree; without them it is a chain),
    # and gates the refraction/stack machinery of the lane machine.
    any_dielectric: bool = True
    # Static material-class flags: compiled programs skip whole shading
    # branches (8-BRDF blend, conductor Fresnel, glossy jitter) when no
    # material of that class exists — the masks would be all-False anyway.
    any_brdf: bool = True
    any_conductor: bool = True
    any_rough: bool = True
    bg_texture: int = -1    # texture index with ReplaceBackground decal, or -1
    env_texture: int = -1   # texture index of the environment light image
    n_textures: int = 0
    texture_statics: Tuple[Tuple[int, int, int, int], ...] = ()


@dataclasses.dataclass
class LoadedScene:
    """Load result: device scene pytree + host-side cameras & names."""

    scene: Scene
    cameras: list
    path: str
