"""Scene: the pytree-of-SoA-arrays that lives in HBM.

The replacement for the reference's `SceneState` CPU arrays
(src/scene.rs:6-17) + the combined-metadata GPU buffer packing
(src/buffers.rs:157-271): instead of one u32 blob with manual
offset decoding (shader/src/scene_access.rs), the scene is a typed pytree that
`jax.device_put` ships to the device in one transfer and `jit` treats as regular
operands. Triangle data is additionally pre-expanded to Möller-Trumbore form
(v0, e1, e2) in **BVH leaf order**, so traversal leaf tests are contiguous
vector reads.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import RaytracerConfig, DEFAULT_CONFIG
from ..utils.pytree import pytree_dataclass, replace
from .camera import Camera
from .geometry import Mesh, Spheres, Textures, dedup_triangles
from .light import LightBuilder, Lights
from .material import MaterialBuilder, Materials
from .bvh import Bvh, build_bvh, BvhBuildResult


@pytree_dataclass
class Scene:
    camera: Camera
    spheres: Spheres
    mesh: Mesh              # original triangle order (parity/refit/export)
    materials: Materials
    lights: Lights
    textures: Textures
    bvh: Bvh
    # Leaf-ordered, Möller-Trumbore-expanded triangles (padded to a multiple
    # of the leaf size with degenerate triangles that can never hit):
    tri_v0: jnp.ndarray     # [Tp,3] f32
    tri_e1: jnp.ndarray     # [Tp,3] f32  (v1 - v0)
    tri_e2: jnp.ndarray     # [Tp,3] f32  (v2 - v0)
    tri_mat: jnp.ndarray    # [Tp] i32
    tri_uv: jnp.ndarray     # [Tp,3,2] f32 per-corner texture coordinates
    # Original triangle id behind each leaf slot (-1 = padding): the
    # topology-preserving refit re-expands (v0,e1,e2) through this map.
    tri_src: jnp.ndarray | None = None   # [Tp] i32

    @property
    def num_triangles(self) -> int:
        return self.mesh.num_triangles

    def with_camera(self, camera: Camera) -> "Scene":
        return replace(self, camera=camera)


def _expand_triangles(vertices: np.ndarray, indices: np.ndarray,
                      material_id: np.ndarray, uv: np.ndarray,
                      order: np.ndarray, pad_to: int):
    """Gather + expand triangles into (v0, e1, e2, mat, uv) in `order`,
    padding with degenerate (zero-edge) triangles the intersector rejects."""
    v = np.asarray(vertices, np.float32)
    order = np.asarray(order, np.int64)
    pad_slot = order < 0                       # leaf-alignment padding
    safe = np.where(pad_slot, 0, order)
    idx = np.asarray(indices, np.int64)[safe]
    mat = np.asarray(material_id, np.int64)[safe]
    t = np.asarray(uv, np.float32)
    v0 = v[idx[:, 0]]
    e1 = v[idx[:, 1]] - v0
    e2 = v[idx[:, 2]] - v0
    tuv = t[idx]                               # [T,3,2]
    if pad_slot.any():
        z = pad_slot[:, None]
        v0 = np.where(z, 0.0, v0)
        e1 = np.where(z, 0.0, e1)              # zero edges → det 0 → no hit
        e2 = np.where(z, 0.0, e2)
        mat = np.where(pad_slot, 0, mat)
        tuv = np.where(pad_slot[:, None, None], 0.0, tuv)
    T = v0.shape[0]
    Tp = max(((T + pad_to - 1) // pad_to) * pad_to, pad_to)
    if Tp != T:
        pad = Tp - T
        z = np.zeros((pad, 3), np.float32)
        v0 = np.concatenate([v0, z])
        e1 = np.concatenate([e1, z])
        e2 = np.concatenate([e2, z])
        mat = np.concatenate([mat, np.zeros(pad, np.int64)])
        tuv = np.concatenate([tuv, np.zeros((pad, 3, 2), np.float32)])
    src = np.where(pad_slot, -1, order)
    if Tp != T:
        src = np.concatenate([src, np.full(Tp - T, -1, np.int64)])
    return (jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
            jnp.asarray(mat.astype(np.int32)), jnp.asarray(tuv),
            jnp.asarray(src.astype(np.int32)))


def _corner_keys(vertices: np.ndarray, indices: np.ndarray,
                 uv: np.ndarray) -> np.ndarray:
    """[T, 3, K] u32 per-corner content keys: zero-sign-normalised position
    bits then uv bits (+0.0 folds -0.0 — the glTF node-transform multiply
    rewrites -0.0 to +0.0, and the two are render-identical)."""
    idx = np.asarray(indices, np.int64)
    p = np.ascontiguousarray(
        np.asarray(vertices, np.float32)[idx] + 0.0).view(np.uint32)
    parts = [p]                                           # [T,3,3]
    uv = np.asarray(uv, np.float32)
    if uv.size:
        parts.append(np.ascontiguousarray(uv[idx] + 0.0).view(np.uint32))
    return np.concatenate(parts, axis=2)


def _canonical_corner_rotation(vertices: np.ndarray, indices: np.ndarray,
                               uv: np.ndarray) -> np.ndarray:
    """Cyclically rotate each index triple so its lexicographically-smallest
    corner (by _corner_keys) leads. Winding — and therefore the geometric
    normal e1 x e2 — is preserved; Möller-Trumbore accepts any rotation, but
    the EXPANDED (v0, e1, e2) float values depend on which corner is v0, so
    exact-t comparisons are only reproducible across builds if every build
    picks the same rotation."""
    idx = np.asarray(indices)
    T = idx.shape[0]
    key = _corner_keys(vertices, idx, uv)                 # [T,3,K]
    best = np.zeros(T, np.int64)
    ar = np.arange(T)
    for c in (1, 2):
        cur = key[ar, best]                               # [T,K]
        cand = key[:, c]
        lt = np.zeros(T, bool)
        decided = np.zeros(T, bool)
        for k in range(key.shape[2]):
            l = ~decided & (cand[:, k] < cur[:, k])
            g = ~decided & (cand[:, k] > cur[:, k])
            lt |= l
            decided |= l | g
        best = np.where(lt, c, best)
    return np.stack([idx[ar, (best + k) % 3] for k in range(3)],
                    axis=1).astype(idx.dtype)


def _canonical_tri_order(vertices: np.ndarray, indices: np.ndarray,
                         material_id: np.ndarray,
                         uv: np.ndarray) -> np.ndarray:
    """Deterministic content-based triangle permutation: lexsort over the
    zero-normalised u32 bit patterns of the three corner positions, the
    three corner uvs and the material id (bit patterns, not float compares
    — total order, no NaN pitfalls). Two scenes holding the same triangle
    SET (in canonical corner rotation) sort to the same sequence regardless
    of how they were built."""
    T = indices.shape[0]
    key = np.concatenate(
        [_corner_keys(vertices, indices, uv).reshape(T, -1),
         np.asarray(material_id, np.uint32).reshape(T, 1)], axis=1)
    # np.lexsort's LAST key is primary: feed columns reversed so column 0
    # (v0.x bits) leads.
    return np.lexsort(tuple(key[:, c]
                            for c in range(key.shape[1] - 1, -1, -1)))


def prepare_scene(
    camera: Camera,
    spheres: Spheres,
    mesh: Mesh,
    materials: Materials,
    lights: Lights,
    textures: Textures | None = None,
    config: RaytracerConfig = DEFAULT_CONFIG,
    bvh_result: BvhBuildResult | None = None,
) -> Scene:
    """Assemble a device scene: build the BVH (host, unless given), reorder
    triangles into leaf order, precompute edges. Mirrors SceneState::new's
    always-rebuild-BVH behaviour (src/scene.rs:20-127)."""
    # Canonical direction normalisation: the glTF loader can only recover
    # NORMALISED camera/light directions (they ride rotation matrices,
    # gltf.py:547-558), while procedural builders keep raw vectors — the
    # last bit-level difference between a scene and its GLB round trip
    # (ray directions off by ulps flipped isolated edge pixels at 4.4e-2).
    # Normalising is semantically free: the camera basis is scale-
    # invariant (SURVEY ray.rs row) and shading normalises light
    # directions at use.
    # IDEMPOTENT at f32 (same rule as the loader's _normalize): vectors
    # already unit pass through bit-unchanged, others normalise in f64 —
    # so normalise(normalise(x)) == normalise(x) bitwise across the
    # writer -> loader -> prepare chain.
    def _unit(v):
        v64 = np.asarray(v, np.float64)
        n = float(np.linalg.norm(v64))
        if n == 0.0 or abs(n - 1.0) <= 1e-6:
            return np.asarray(v, np.float32)
        return (v64 / n).astype(np.float32)

    camera = replace(camera,
                     direction=jnp.asarray(_unit(camera.direction)),
                     up=jnp.asarray(_unit(camera.up)))
    ld = np.asarray(lights.direction, np.float64)
    nrm = np.linalg.norm(ld, axis=1, keepdims=True)
    unit_rows = np.abs(nrm - 1.0) <= 1e-6
    scale = np.where((nrm == 0.0) | unit_rows, 1.0, nrm)
    lights = replace(lights, direction=jnp.asarray(
        (ld / scale).astype(np.float32)))

    vertices = np.asarray(mesh.vertices)
    indices = np.asarray(mesh.indices)
    material_id = np.asarray(mesh.material_id)
    textured = textures is not None and int(
        np.prod(np.asarray(textures.data_u32).shape)) > 1
    canon = None
    if bvh_result is None and indices.shape[0] > 1:
        # Canonical triangle form: (1) rotate every index triple so its
        # smallest corner leads (stored back into the mesh, so refit
        # re-expansion and GLB export stay consistent), then (2) sort the
        # build sequence by CONTENT (position/uv bit patterns + material).
        # Any two scenes with the same triangle set — e.g. a procedural
        # build and its GLB export -> per-material regroup -> dedup ->
        # import round trip, which permutes the sequence AND the corner
        # rotation — then expand to BIT-IDENTICAL leaf tables, so exact-t
        # ties on shared edges resolve identically in every kernel (the
        # ordered kernels' strict-< winner keeps the first slot in
        # traversal order; the round trip used to flip isolated
        # shared-edge pixels at 4.4e-2 — BASELINE config 4 parity).
        # Stable lexsort: fully identical rows are indistinguishable.
        muv = np.asarray(mesh.uv)
        indices = _canonical_corner_rotation(vertices, indices, muv)
        mesh = replace(mesh, indices=jnp.asarray(indices))
        canon = _canonical_tri_order(vertices, indices, material_id, muv)
        indices = indices[canon]
        material_id = material_id[canon]
    if bvh_result is None:
        if config.bvh_spatial_splits:
            from .bvh import build_bvh_spatial

            bvh_result = build_bvh_spatial(vertices, indices,
                                           leaf_size=config.bvh_leaf_size)
        else:
            bvh_result = build_bvh(vertices, indices,
                                   leaf_size=config.bvh_leaf_size)
    tri_v0, tri_e1, tri_e2, tri_mat, tri_uv, tri_src = _expand_triangles(
        vertices, indices, material_id, np.asarray(mesh.uv),
        bvh_result.tri_order, pad_to=8,
    )
    if canon is not None:
        # tri_src must keep indexing mesh.indices' ORIGINAL order (the
        # refit path gathers through it) — compose through the canonical
        # permutation.
        src = np.asarray(tri_src)
        tri_src = jnp.asarray(
            np.where(src >= 0, canon[np.maximum(src, 0)], -1)
            .astype(np.int32))
    return Scene(
        camera=camera,
        spheres=spheres,
        mesh=mesh.to_device() if hasattr(mesh, "to_device") else mesh,
        materials=materials,
        lights=lights,
        textures=textures if textures is not None else Textures.empty(),
        bvh=bvh_result.to_device(),
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_mat=tri_mat,
        tri_uv=tri_uv, tri_src=tri_src,
    )


@jax.jit
def _refit_core(vertices, indices, material_id, uv):
    """Jitted refit pipeline over the MINIMAL inputs (vertex positions +
    static mesh topology) so every refit — including the first one from a
    host-built scene, whose Scene pytree has different shapes — shares ONE
    compiled executable."""
    from ..ops.lbvh import build_lbvh_grouped_arrays

    GROUP = 8
    a = vertices[indices[:, 0]]
    b = vertices[indices[:, 1]]
    c = vertices[indices[:, 2]]
    tri_min = jnp.minimum(a, jnp.minimum(b, c))
    tri_max = jnp.maximum(a, jnp.maximum(b, c))
    (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
     order) = build_lbvh_grouped_arrays(tri_min, tri_max)
    v0 = a[order]
    e1 = b[order] - v0
    e2 = c[order] - v0
    mat = material_id[order]
    tuv = uv[indices][order]                      # [T,3,2]
    srcs = order.astype(jnp.int32)
    T = v0.shape[0]
    pad = (-T) % GROUP
    if pad:
        z = jnp.zeros((pad, 3), jnp.float32)
        v0 = jnp.concatenate([v0, z])
        e1 = jnp.concatenate([e1, z])   # zero edges -> det 0 -> no hit
        e2 = jnp.concatenate([e2, z])
        mat = jnp.concatenate([mat, jnp.zeros((pad,), jnp.int32)])
        tuv = jnp.concatenate([tuv, jnp.zeros((pad, 3, 2), jnp.float32)])
        srcs = jnp.concatenate([srcs, jnp.full((pad,), -1, jnp.int32)])
    return (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
            v0, e1, e2, mat, tuv, srcs)


@jax.jit
def _refit_topology_core(vertices, indices, tri_src, bvh):
    """Topology-preserving BVH refit: keep the tree (links, leaf ranges)
    and resweep only the GEOMETRY — re-expanded triangles and bottom-up
    node AABBs. The classic refit: tree quality stays at build quality for moderate
    deformation, and NOTHING about the scene's shapes changes, so every
    per-frame refit after the first is a pure jit-cache hit."""
    Tp = tri_src.shape[0]
    big = jnp.float32(3.0e38)
    valid = tri_src >= 0
    safe = jnp.clip(tri_src, 0, indices.shape[0] - 1)
    idx = indices[safe]                                  # [Tp,3]
    a = vertices[idx[:, 0]]
    b = vertices[idx[:, 1]]
    c = vertices[idx[:, 2]]
    vm = valid[:, None]
    v0 = jnp.where(vm, a, 0.0)
    e1 = jnp.where(vm, b - a, 0.0)   # zero edges -> det 0 -> no hit
    e2 = jnp.where(vm, c - a, 0.0)
    tmin = jnp.where(vm, jnp.minimum(a, jnp.minimum(b, c)), big)
    tmax = jnp.where(vm, jnp.maximum(a, jnp.maximum(b, c)), -big)

    is_leaf = bvh.left < 0
    N = bvh.left.shape[0]
    nm = jnp.full((N, 3), big)
    nx = jnp.full((N, 3), -big)
    for j in range(bvh.max_leaf):    # static unroll: leaf AABBs
        ok = (j < bvh.tri_count) & is_leaf
        sidx = jnp.clip(bvh.tri_start + j, 0, Tp - 1)
        nm = jnp.where(ok[:, None], jnp.minimum(nm, tmin[sidx]), nm)
        nx = jnp.where(ok[:, None], jnp.maximum(nx, tmax[sidx]), nx)
    lc = jnp.clip(bvh.left, 0, N - 1)
    rc = jnp.clip(bvh.right, 0, N - 1)
    lf = is_leaf[:, None]

    def body(t, cbox):               # bottom-up child-gather sweeps
        bm, bx = cbox
        im = jnp.minimum(bm[lc], bm[rc])
        ix = jnp.maximum(bx[lc], bx[rc])
        return jnp.where(lf, bm, im), jnp.where(lf, bx, ix)

    nm, nx = jax.lax.fori_loop(0, bvh.depth, body, (nm, nx))
    return replace(bvh, node_min=nm, node_max=nx), v0, e1, e2


def refit_scene(scene: Scene, vertices: jnp.ndarray,
                rebuild: bool = False) -> Scene:
    """Per-frame on-device BVH update for animated geometry.

    The reference rebuilds its BVH on the HOST every scene change
    (src/scene.rs:107-109) — fine for load events, a
    pipeline stall if geometry moves per frame. Two on-device modes:

    * **topology refit** (default, `scene.tri_src` present): keep the
      tree and resweep AABBs + re-expand triangles
      (`_refit_topology_core`) — SAH quality survives, all shapes are
      unchanged (zero recompiles frame-to-frame), cost is a handful of
      gathers. The standard answer for deforming geometry.
    * **full rebuild** (`rebuild=True`, or no tri_src): Morton codes →
      sort → Karras hierarchy over 8-triangle leaf groups (ops/lbvh.py)
      — for large deformations or changed topology, where a refit tree's
      quality would erode."""
    GROUP = 8
    vertices = jnp.asarray(vertices, jnp.float32)
    if not rebuild and scene.tri_src is not None:
        bvh, v0, e1, e2 = _refit_topology_core(
            vertices, scene.mesh.indices.astype(jnp.int32),
            scene.tri_src, scene.bvh)
        mesh = replace(scene.mesh, vertices=vertices)
        return replace(scene, mesh=mesh, bvh=bvh, tri_v0=v0, tri_e1=e1,
                       tri_e2=e2)
    (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
     v0, e1, e2, mat, tuv, srcs) = _refit_core(
        vertices, scene.mesh.indices.astype(jnp.int32),
        scene.mesh.material_id.astype(jnp.int32), scene.mesh.uv)
    bvh = Bvh(node_min=nmin, node_max=nmax, left=left, right=right,
              tri_start=tri_start, tri_count=tri_count,
              hit_link=hit, miss_link=miss, max_leaf=GROUP, depth=128)
    mesh = replace(scene.mesh, vertices=vertices)
    return replace(scene, mesh=mesh, bvh=bvh, tri_v0=v0, tri_e1=e1,
                   tri_e2=e2, tri_mat=mat, tri_uv=tuv, tri_src=srcs)


def build_default_scene(config: RaytracerConfig = DEFAULT_CONFIG) -> Scene:
    """The reference demo scene — SceneBuilder::build_default_scene
    (shared/src/lib.rs:1242-1286): 4 materials, 6 spheres,
    2 triangles, 1 point light, default camera."""
    mats = MaterialBuilder()
    mats.add_diffuse((0.8, 0.3, 0.3))                 # 0: red diffuse
    mats.add_metallic((0.8, 0.8, 0.2), 0.1)           # 1: yellow metal
    mats.add_glass((0.2, 0.3, 0.8), 1.5, 0.9)         # 2: blue glass
    mats.add_emissive((1.0, 1.0, 1.0), (0.5, 0.5, 1.0))  # 3: blue light

    spheres = Spheres.from_rows([
        ((0.0, 0.0, -1.0), 0.5, 0),
        ((-1.0, 0.0, -1.0), 0.5, 1),
        ((1.0, 0.0, -1.0), 0.5, 2),
        ((2.0, 0.0, -3.0), 0.5, 2),
        ((-2.0, 0.0, -4.0), 0.5, 1),
        ((-1.0, 2.0, -5.0), 0.5, 3),
    ])

    tri_verts = np.asarray([
        [[0.0, 1.0, -2.0], [-0.5, 0.0, -2.0], [0.5, 0.0, -2.0]],
        [[1.5, 0.5, -3.0], [1.0, -0.5, -3.0], [2.0, -0.5, -3.0]],
    ], np.float32)
    v, i, m = dedup_triangles(tri_verts, np.asarray([0, 1], np.uint32))
    mesh = Mesh.from_arrays(v, i, m)

    lb = LightBuilder()
    lb.add_point((5.0, 7.0, 4.0), (1.0, 1.0, 1.0), 1.0, float("inf"))

    return prepare_scene(Camera.default(), spheres, mesh, mats.build(),
                         lb.build(), config=config)


def memory_stats(scene: Scene) -> dict:
    """Byte accounting per component — the reference's memory-usage dashboard
    (src/scene.rs:130-206)."""
    def nbytes(x):
        # .nbytes avoids pulling device arrays back to the host
        return sum(l.nbytes for l in jax.tree_util.tree_leaves(x))

    tris = scene.mesh.num_triangles
    verts = scene.mesh.num_vertices
    stats = {
        "spheres_bytes": nbytes(scene.spheres),
        "mesh_bytes": nbytes(scene.mesh),
        "expanded_tri_bytes": scene.tri_v0.nbytes * 3 + scene.tri_mat.nbytes,
        "materials_bytes": nbytes(scene.materials),
        "lights_bytes": nbytes(scene.lights),
        "textures_bytes": nbytes(scene.textures),
        "bvh_bytes": nbytes(scene.bvh),
        "triangles": tris,
        "vertices": verts,
        "bvh_nodes": scene.bvh.num_nodes,
    }
    stats["total_bytes"] = sum(v for k, v in stats.items() if k.endswith("_bytes"))
    # Vertex-dedup saving vs fat triangles (scene.rs:168-183).
    fat = tris * 9 * 4
    stats["dedup_savings_bytes"] = max(fat - verts * 12, 0)
    return stats


def print_memory_usage(scene: Scene) -> None:
    s = memory_stats(scene)

    def mb(b):
        if b < 1024 * 1024:
            return f"{b / 1024:8.2f} KB"
        return f"{b / (1024 * 1024):8.2f} MB"
    print("=== Scene memory usage ===")
    for key in ("spheres_bytes", "mesh_bytes", "expanded_tri_bytes",
                "materials_bytes", "lights_bytes", "textures_bytes", "bvh_bytes"):
        print(f"  {key[:-6]:>14}: {mb(s[key])}")
    print(f"  {'total':>14}: {mb(s['total_bytes'])}")
    print(f"  triangles={s['triangles']} vertices={s['vertices']} "
          f"bvh_nodes={s['bvh_nodes']} dedup_savings={mb(s['dedup_savings_bytes'])}")
