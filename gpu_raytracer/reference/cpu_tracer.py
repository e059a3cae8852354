"""NumPy oracle tracer (SURVEY.md §7 P0).

An independent, deliberately-naive brute-force implementation of the
reference render semantics (shader/src/: ray.rs,
intersection.rs, lighting.rs, material.rs, lib.rs) used as the golden oracle
for RMSE and bit-stability tests of the JAX path. No BVH, no batching tricks
— every ray tests every primitive, mirroring the reference's sequential
per-thread loops, including their tie rules (strict `<` with earlier
primitive winning) and the f16 round-trips.

All arithmetic is kept in float32 (NumPy weak-promotion discipline: every
named intermediate is np.float32), because the reference GPU computes in f32
and seam/boundary decisions (e.g. Möller-Trumbore's u+v <= 1) flip between
f32 and f64.
"""

from __future__ import annotations

import numpy as np

MIN_T = np.float32(1e-5)
F32_MAX = np.float32(3.4028235e38)
DISPERSION = np.array([-0.018, 0.0, 0.035], np.float32)

f32 = np.float32


def _f16(x):
    return np.float32(np.float16(np.float32(x)))


def unpack_f16_pair(u):
    lo = np.array(u & 0xFFFF, np.uint16).view(np.float16).astype(np.float32)
    hi = np.array((u >> 16) & 0xFFFF, np.uint16).view(np.float16).astype(np.float32)
    return f32(lo), f32(hi)


def _dot(a, b):
    return f32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], np.float32)


def _normalize(v):
    return (v / np.sqrt(_dot(v, v))).astype(np.float32)


def _max0(x):
    # Rust f32::max(0.0): NaN -> 0
    return f32(x) if x > 0.0 else f32(0.0)


def camera_ray(cam, width, height, x, y):
    """ray.rs:22-53."""
    u = f32((f32(x) + f32(0.5)) / f32(width))
    v = f32((f32(y) + f32(0.5)) / f32(height))
    aspect = f32(f32(width) / f32(height))
    fov_scale = f32(np.tan(f32(cam["fov"]) * f32(0.5) * f32(np.pi) / f32(180.0)))
    cx = f32((u * 2.0 - 1.0) * aspect * fov_scale)
    cy = f32((1.0 - v * 2.0) * fov_scale)
    forward = np.asarray(cam["direction"], np.float32)
    up = np.asarray(cam["up"], np.float32)
    right = _cross(forward, up)
    true_up = _cross(right, forward)
    d = (forward + right * cx + true_up * cy).astype(np.float32)
    return np.asarray(cam["position"], np.float32), _normalize(d)


def sphere_hit(o, d, center, radius, max_t):
    """intersection.rs:52-87 → (t, hit)."""
    oc = (o - center).astype(np.float32)
    a = _dot(d, d)
    b = f32(2.0 * _dot(oc, d))
    c = f32(_dot(oc, oc) - f32(radius) * f32(radius))
    disc = f32(b * b - 4.0 * a * c)
    if disc < 0.0:
        return F32_MAX, False
    sq = f32(np.sqrt(disc))
    t1 = f32((-b - sq) / (2.0 * a))
    t2 = f32((-b + sq) / (2.0 * a))
    t = t1 if t1 > MIN_T else t2
    if t > MIN_T and t < max_t:
        return t, True
    return F32_MAX, False


def triangle_hit(o, d, v0, v1, v2, max_t):
    """intersection.rs:91-138 → (t, hit)."""
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    return triangle_hit_edges(o, d, v0, e1, e2, max_t)


def triangle_hit_edges(o, d, v0, e1, e2, max_t):
    """Möller-Trumbore with pre-expanded edges (bit-identical to
    triangle_hit; used for leaf-ordered expanded scenes)."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    if abs(a) < MIN_T:
        return F32_MAX, False
    f = f32(1.0 / a)
    s = (o - v0).astype(np.float32)
    u = f32(f * _dot(s, h))
    if u < 0.0 or u > 1.0:
        return F32_MAX, False
    q = _cross(s, e1)
    v = f32(f * _dot(d, q))
    if v < 0.0 or u + v > 1.0:
        return F32_MAX, False
    t = f32(f * _dot(e2, q))
    if t > MIN_T and t < max_t:
        return t, True
    return F32_MAX, False


def closest_hit(scene, o, d, max_t=None):
    """find_closest_intersection (shader/src/lib.rs:174-249): spheres first,
    triangles pruned at the sphere t. Returns dict or None."""
    if max_t is None:
        max_t = f32(F32_MAX - 2.0)
    best = None
    closest = max_t
    for i, (c, r, mid) in enumerate(scene["spheres"]):
        c = np.asarray(c, np.float32)
        t, ok = sphere_hit(o, d, c, f32(r), closest)
        if ok:
            closest = t
            p = (o + d * t).astype(np.float32)
            best = dict(t=t, point=p, normal=_normalize((p - c).astype(np.float32)),
                        material_id=mid, kind="sphere", prim=i)
    tri_limit = closest
    if "triangles_expanded" in scene:
        # Leaf-ordered expanded triangles: the iteration (and therefore the
        # exact-tie winner) follows the BVH's DFS leaf order — the order the
        # reference's stack traversal tests triangles in via the
        # triangle-index indirection (shader/src/bvh.rs:91-133). The
        # original-index loop below instead models the brute-force path
        # (shader/src/lib.rs test_all_triangles_brute_force); the two differ
        # only on degenerate exact-t ties.
        for j, (v0, e1, e2, mid) in enumerate(scene["triangles_expanded"]):
            t, ok = triangle_hit_edges(o, d, v0, e1, e2, tri_limit)
            if ok:
                tri_limit = t
                p = (o + d * t).astype(np.float32)
                n = _normalize(_cross(e1, e2))
                best = dict(t=t, point=p, normal=n, material_id=mid,
                            kind="triangle", prim=j)
        return best
    for j, (i0, i1, i2, mid) in enumerate(scene["triangles"]):
        v0 = scene["vertices"][i0]
        v1 = scene["vertices"][i1]
        v2 = scene["vertices"][i2]
        t, ok = triangle_hit(o, d, v0, v1, v2, tri_limit)
        if ok:
            tri_limit = t
            p = (o + d * t).astype(np.float32)
            n = _normalize(_cross((v1 - v0).astype(np.float32),
                                  (v2 - v0).astype(np.float32)))
            best = dict(t=t, point=p, normal=n, material_id=mid,
                        kind="triangle", prim=j)
    return best


def light_contribution(scene, hit, light, mat):
    """lighting.rs:50-139 (branchless blend reproduced with plain ifs +
    Rust-max semantics)."""
    n = hit["normal"]
    p = hit["point"]
    pos = np.asarray(light["position"], np.float32)
    ldir = np.asarray(light["direction"], np.float32)
    lt = light["light_type"]
    intensity = f32(light["intensity"])

    # directional part
    with np.errstate(invalid="ignore", divide="ignore"):
        dnorm = _normalize(ldir)
        dir_dot = _dot(n, -dnorm)
    dir_I = f32(_max0(dir_dot) * intensity)

    # point/spot part
    to_light = (pos - p).astype(np.float32)
    dist = f32(np.sqrt(_dot(to_light, to_light)))
    with np.errstate(invalid="ignore", divide="ignore"):
        pl = (to_light / dist).astype(np.float32)
        atten = _f16(f32(1.0) / (f32(1.0) + dist * dist * f32(0.01)))
        pdot = _dot(n, pl)
    point_I = f32(_max0(pdot) * intensity * atten)
    with np.errstate(invalid="ignore"):
        sdot = _dot(-dnorm, pl)
    spot_I = f32(point_I * _max0(sdot))

    I = f32(dir_I * (lt == 0) + point_I * (lt == 1) + spot_I * (lt == 2))

    # BRDF (material.rs:76-83)
    metallic, _ = unpack_f16_pair(mat["metallic_roughness_f16"])
    albedo = np.asarray(mat["albedo"], np.float32)
    is_m = f32(1.0) if metallic > 0.5 else f32(0.0)
    brdf = (albedo * I * f32(0.5) * is_m
            + (albedo / f32(np.pi)) * I * (f32(1.0) - is_m)).astype(np.float32)
    valid = f32(1.0) if I > 0.0 else f32(0.0)
    return (brdf * np.asarray(light["color"], np.float32) * valid).astype(np.float32)


def shade(scene, hit, channel):
    """calculate_shading (lib.rs:299-338) for a single channel 0/1/2."""
    mats = scene["materials"]
    if hit["material_id"] >= len(mats):
        return np.array([1.0, 0.0, 1.0], np.float32)
    mat = mats[hit["material_id"]]
    albedo = np.asarray(mat["albedo"], np.float32)
    total = (albedo * f32(0.1)).astype(np.float32)
    for light in scene["lights"]:
        total = (total + light_contribution(scene, hit, light, mat)).astype(np.float32)
    total = (total + np.asarray(mat["emission"], np.float32)).astype(np.float32)

    ior, trans = unpack_f16_pair(mat["ior_transmission_f16"])
    trans = f32(min(max(trans, f32(0.0)), f32(1.0)))
    if trans > 0.0:
        # ior_for_channel (material.rs:42-58); channel >= 3 uses the 0.0 fallback
        wl = f32(ior + (DISPERSION[channel] if channel < 3 else f32(0.0)))
        with np.errstate(invalid="ignore", divide="ignore"):
            disp = f32((wl - 1.0) / (ior - 1.0))
        transmitted = (np.array([0.2, 0.2, 0.3], np.float32) * disp).astype(np.float32)
        return (total * (f32(1.0) - trans) + transmitted * trans).astype(np.float32)
    return total


def render(scene, width, height):
    """Full-frame oracle render with the 3-channel-pass recombination
    (main_fs, lib.rs:367-391): out[c] = pass_c[c]. → [H,W,3] f32."""
    img = np.zeros((height, width, 3), np.float32)
    for y in range(height):
        for x in range(width):
            o, d = camera_ray(scene["camera"], width, height, x, y)
            hit = closest_hit(scene, o, d)
            if hit is None:
                continue
            for c in range(3):
                img[y, x, c] = shade(scene, hit, c)[c]
    return img


def scene_dict_from(scene) -> dict:
    """Convert a gpu_raytracer Scene pytree to the oracle's dict format."""
    import numpy as onp

    sp = scene.spheres
    mats = []
    m = scene.materials
    for i in range(m.count):
        mats.append(dict(
            albedo=onp.asarray(m.albedo[i]),
            emission=onp.asarray(m.emission[i]),
            metallic_roughness_f16=int(m.metallic_roughness_f16[i]),
            ior_transmission_f16=int(m.ior_transmission_f16[i]),
        ))
    lights = []
    Lt = scene.lights
    for i in range(Lt.count):
        lights.append(dict(
            position=onp.asarray(Lt.position[i]),
            direction=onp.asarray(Lt.direction[i]),
            color=onp.asarray(Lt.color[i]),
            intensity=float(Lt.intensity[i]),
            light_type=int(Lt.light_type[i]),
        ))
    cam = dict(
        position=onp.asarray(scene.camera.position),
        direction=onp.asarray(scene.camera.direction),
        up=onp.asarray(scene.camera.up),
        fov=float(scene.camera.fov),
    )
    # Leaf-ordered expanded triangles (the device path's canonical order),
    # so oracle exact-tie winners match the BVH traversal's. Padding
    # triangles have zero edges → determinant 0 → always rejected.
    tv0 = onp.asarray(scene.tri_v0, onp.float32)
    te1 = onp.asarray(scene.tri_e1, onp.float32)
    te2 = onp.asarray(scene.tri_e2, onp.float32)
    tmm = onp.asarray(scene.tri_mat)
    return dict(
        camera=cam,
        spheres=[(onp.asarray(sp.center[i]), float(sp.radius[i]), int(sp.material_id[i]))
                 for i in range(sp.count)],
        vertices=onp.asarray(scene.mesh.vertices),
        triangles=[(int(a), int(b), int(c), int(mm)) for (a, b, c), mm in
                   zip(onp.asarray(scene.mesh.indices), onp.asarray(scene.mesh.material_id))],
        triangles_expanded=[(tv0[i], te1[i], te2[i], int(tmm[i]))
                            for i in range(tv0.shape[0])],
        materials=mats,
        lights=lights,
    )
