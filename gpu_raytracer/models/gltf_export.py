"""GLB writer — the mirror of models/gltf.py's reader.

The reference only ever READS glTF (src/gltf_loader.rs); the
environment however ships no glTF assets (zero egress), so BASELINE config 4
("Sponza glTF: load → BVH → PBR render") needs the Sponza-scale content
exported as a real .glb first. `export_glb` serialises a device `Scene`
(plus its source texture images) into a self-contained binary glTF 2.0 asset
that `GltfLoader` ingests through the exact code paths real asset packs use:
GLB chunking, accessors/bufferViews, per-primitive materials, KHR material
extensions, KHR_lights_punctual, a camera node, and PNG images embedded as
bufferViews.

Round-trip fidelity notes:
  * material scalars are stored f16-packed in the Scene; the writer exports
    the DECODED f32 values and the loader re-encodes them — f16(f32(f16(x)))
    is idempotent, so packing round-trips bit-exactly.
  * per-triangle materials become one glTF primitive per material (glTF has
    no per-triangle material), sharing single POSITION/TEXCOORD_0 accessors;
    the loader re-dedups per primitive, so vertex/triangle ORDER differs
    from the source scene while the triangle SET (and the render) is
    preserved.
  * spheres have no glTF encoding and are not exported.
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np

from ..ops.f16 import unpack_f16_pair_host
from .material import (NO_TEXTURE, TEX_BASE_COLOR, TEX_EMISSIVE,
                       TEX_METALLIC_ROUGHNESS, TEX_NORMAL, TEX_OCCLUSION,
                       TEX_SG_SPECGLOSS)
from .scene import Scene


def _aim_matrix(direction, up=None, position=(0.0, 0.0, 0.0)) -> list:
    """Column-major glTF node matrix whose local -Z maps to `direction` and
    local +Y to `up` — the exact inverse of the loader's convention
    (GltfLoader._convert_camera/_convert_light: dir = R@(0,0,-1),
    up = R@(0,1,0), position = translation)."""
    d = np.asarray(direction, np.float64)
    n = np.linalg.norm(d)
    if abs(n - 1.0) > 1e-6:   # idempotent at f32, like loader/_prepare
        d = d / n
    if up is None:
        up = (0.0, 1.0, 0.0) if abs(d[1]) < 0.9 else (1.0, 0.0, 0.0)
    u = np.asarray(up, np.float64)
    r = np.cross(d, u)
    n = np.linalg.norm(r)
    r = r / n if n > 1e-12 else np.asarray([1.0, 0.0, 0.0])
    m = np.eye(4)
    m[:3, 0] = r
    m[:3, 1] = u
    m[:3, 2] = -d
    m[:3, 3] = np.asarray(position, np.float64)
    return [float(x) for x in m.T.reshape(-1)]  # transpose → column-major


def _material_json(mats, i: int, n_textures: int) -> dict:
    """One glTF material dict from row `i` of the Materials SoA — inverse of
    GltfLoader._convert_material (which mirrors
    src/gltf_loader.rs:397-489)."""
    metallic, roughness = (float(x[i]) for x in unpack_f16_pair_host(
        np.asarray(mats.metallic_roughness_f16)))
    ior, transmission = (float(x[i]) for x in unpack_f16_pair_host(
        np.asarray(mats.ior_transmission_f16)))
    albedo = [float(x) for x in np.asarray(mats.albedo)[i]]
    emission = [float(x) for x in np.asarray(mats.emission)[i]]
    spec_f = float(np.asarray(mats.specular_factor)[i])
    spec_c = [float(x) for x in np.asarray(mats.specular_color)[i]]
    att_d = float(np.asarray(mats.attenuation_distance)[i])
    att_c = [float(x) for x in np.asarray(mats.attenuation_color)[i]]
    thick = float(np.asarray(mats.thickness_factor)[i])
    ti = np.asarray(mats.texture_indices)[i]

    def tex(slot):
        t = int(ti[slot])
        if t == int(NO_TEXTURE) or t >= n_textures:
            return None
        return {"index": t}

    gm: dict = {"extensions": {}}
    if int(np.asarray(mats.material_type)[i]) == 1:   # spec-gloss
        sg = {
            "diffuseFactor": [float(x) for x in
                              np.asarray(mats.diffuse_factor)[i]] + [1.0],
            "specularFactor": spec_c,
            "glossinessFactor": float(np.asarray(mats.glossiness_factor)[i]),
        }
        if tex(TEX_BASE_COLOR):
            sg["diffuseTexture"] = tex(TEX_BASE_COLOR)
        if tex(TEX_SG_SPECGLOSS):
            sg["specularGlossinessTexture"] = tex(TEX_SG_SPECGLOSS)
        gm["extensions"]["KHR_materials_pbrSpecularGlossiness"] = sg
    else:
        pbr = {"baseColorFactor": albedo + [1.0],
               "metallicFactor": metallic,
               "roughnessFactor": roughness}
        if tex(TEX_BASE_COLOR):
            pbr["baseColorTexture"] = tex(TEX_BASE_COLOR)
        if tex(TEX_METALLIC_ROUGHNESS):
            pbr["metallicRoughnessTexture"] = tex(TEX_METALLIC_ROUGHNESS)
        gm["pbrMetallicRoughness"] = pbr
        if spec_f != 1.0 or spec_c != [1.0, 1.0, 1.0]:
            gm["extensions"]["KHR_materials_specular"] = {
                "specularFactor": spec_f, "specularColorFactor": spec_c}
    if any(e != 0.0 for e in emission):
        gm["emissiveFactor"] = emission
    if transmission > 0.0:
        gm["extensions"]["KHR_materials_transmission"] = {
            "transmissionFactor": transmission}
    if ior != 1.5:
        gm["extensions"]["KHR_materials_ior"] = {"ior": ior}
    if thick != 0.0 or att_c != [1.0, 1.0, 1.0] or math.isfinite(att_d):
        vol = {"thicknessFactor": thick, "attenuationColor": att_c}
        if math.isfinite(att_d):
            vol["attenuationDistance"] = att_d
        gm["extensions"]["KHR_materials_volume"] = vol
    if tex(TEX_NORMAL):
        gm["normalTexture"] = tex(TEX_NORMAL)
    if tex(TEX_OCCLUSION):
        gm["occlusionTexture"] = tex(TEX_OCCLUSION)
    if tex(TEX_EMISSIVE):
        gm["emissiveTexture"] = tex(TEX_EMISSIVE)
    if not gm["extensions"]:
        del gm["extensions"]
    return gm


def _light_json(lights, i: int) -> tuple[dict, dict]:
    """(light dict, node dict) for light `i` — inverse of _convert_light."""
    kind = ("directional", "point", "spot")[int(
        np.asarray(lights.light_type)[i])]
    rng = float(unpack_f16_pair_host(
        np.asarray(lights.range_packed))[0][i])
    inner, outer = (float(x[i]) for x in unpack_f16_pair_host(
        np.asarray(lights.cone_angles_packed)))
    light = {
        "type": kind,
        "color": [float(x) for x in np.asarray(lights.color)[i]],
        "intensity": float(np.asarray(lights.intensity)[i]),
    }
    if kind != "directional" and math.isfinite(rng) and rng > 0.0:
        light["range"] = rng
    if kind == "spot":
        light["spot"] = {"innerConeAngle": inner, "outerConeAngle": outer}
    node = {
        "name": f"light_{i}",
        "matrix": _aim_matrix(
            np.asarray(lights.direction)[i] if kind != "point"
            else (0.0, 0.0, -1.0),
            position=np.asarray(lights.position)[i]),
        "extensions": {"KHR_lights_punctual": {"light": i}},
    }
    return light, node


def export_glb(scene: Scene, path: str,
               images: list[np.ndarray] | None = None,
               texture_wrap: list[int] | None = None) -> None:
    """Write `scene` as a self-contained binary glTF 2.0 (.glb).

    `images`: the texture table's SOURCE images ([H,W,4] u8, level 0), in
    texture-index order — the guard-band mip atlas in `scene.textures` is a
    derived GPU layout, not an interchange format, so the originals must be
    supplied when any material references a texture. `texture_wrap`: per
    texture, 0=REPEAT (default) / 1=CLAMP / 2=MIRRORED."""
    from ..utils.image import encode_png

    mesh = scene.mesh
    verts = np.asarray(mesh.vertices, np.float32)
    idx = np.asarray(mesh.indices, np.uint32)
    mat_id = np.asarray(mesh.material_id, np.uint32)
    uv = np.asarray(mesh.uv, np.float32) if mesh.uv is not None else None
    has_uv = uv is not None and uv.shape[0] == verts.shape[0]

    n_mats = int(np.asarray(scene.materials.albedo).shape[0])
    images = images or []
    ti = np.asarray(scene.materials.texture_indices)
    used = ti[ti != NO_TEXTURE]
    if used.size and (len(images) <= int(used.max())):
        raise ValueError(
            f"scene materials reference texture index {int(used.max())} but "
            f"only {len(images)} source images were supplied")

    bin_parts: list[bytes] = []
    buffer_views: list[dict] = []

    def add_view(data: bytes, target: int | None = None) -> int:
        off = sum(len(p) for p in bin_parts)
        pad = (-off) % 4
        if pad:
            bin_parts.append(b"\x00" * pad)
            off += pad
        bin_parts.append(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    accessors: list[dict] = []

    def add_accessor(arr: np.ndarray, type_: str, ctype: int,
                     minmax: bool = False, target: int | None = None) -> int:
        view = add_view(arr.tobytes(), target)
        acc = {"bufferView": view, "componentType": ctype,
               "count": int(arr.shape[0]), "type": type_}
        if minmax:
            acc["min"] = [float(x) for x in arr.min(0)]
            acc["max"] = [float(x) for x in arr.max(0)]
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add_accessor(verts, "VEC3", 5126, minmax=True, target=34962)
    uv_acc = (add_accessor(uv.astype(np.float32), "VEC2", 5126,
                           target=34962) if has_uv else None)

    # one primitive per material (glTF has no per-triangle materials)
    primitives = []
    for m in sorted(set(int(x) for x in np.unique(mat_id))):
        tri_m = idx[mat_id == m].astype(np.uint32).reshape(-1)
        if tri_m.size == 0:
            continue
        iacc = add_accessor(tri_m.reshape(-1, 1), "SCALAR", 5125,
                            target=34963)
        attrs = {"POSITION": pos_acc}
        if uv_acc is not None:
            attrs["TEXCOORD_0"] = uv_acc
        primitives.append({"attributes": attrs, "indices": iacc,
                           "material": int(m), "mode": 4})

    # images / samplers / textures (PNG bytes embedded in the BIN chunk)
    wrap_gl = {0: 10497, 1: 33071, 2: 33648}
    texture_wrap = texture_wrap or [0] * len(images)
    gltf_images, gltf_samplers, gltf_textures = [], [], []
    for t, img in enumerate(images):
        view = add_view(encode_png(np.ascontiguousarray(img)))
        gltf_images.append({"bufferView": view, "mimeType": "image/png"})
        gltf_samplers.append({"wrapS": wrap_gl.get(texture_wrap[t], 10497),
                              "wrapT": wrap_gl.get(texture_wrap[t], 10497)})
        gltf_textures.append({"source": t, "sampler": t})

    materials = [_material_json(scene.materials, i, len(gltf_textures))
                 for i in range(n_mats)]

    lights_arr, nodes = [], []
    nodes.append({"name": "mesh", "mesh": 0})
    cam = scene.camera
    nodes.append({
        "name": "camera",
        "camera": 0,
        "matrix": _aim_matrix(np.asarray(cam.direction),
                              up=np.asarray(cam.up),
                              position=np.asarray(cam.position)),
    })
    n_lights = int(np.asarray(scene.lights.light_type).shape[0])
    for i in range(n_lights):
        light, node = _light_json(scene.lights, i)
        lights_arr.append(light)
        nodes.append(node)

    doc = {
        "asset": {"version": "2.0", "generator": "gpu_raytracer"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": [{"primitives": primitives}],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": math.radians(float(np.asarray(cam.fov))),
            "znear": 0.001}}],
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "extensionsUsed": ["KHR_lights_punctual",
                           "KHR_materials_transmission",
                           "KHR_materials_ior", "KHR_materials_specular",
                           "KHR_materials_volume",
                           "KHR_materials_pbrSpecularGlossiness"],
        "extensions": {"KHR_lights_punctual": {"lights": lights_arr}},
    }
    if gltf_images:
        doc["images"] = gltf_images
        doc["samplers"] = gltf_samplers
        doc["textures"] = gltf_textures
    if not lights_arr:
        del doc["extensions"]

    bin_chunk = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(bin_chunk)}]
    json_chunk = json.dumps(doc, separators=(",", ":")).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)
    bin_pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * bin_pad

    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
