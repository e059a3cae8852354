"""PBR material model (struct-of-arrays).

Field-for-field port of the reference `Material` struct and its constructors
(shared/src/lib.rs:47-66, impl lib.rs:247-478): albedo/emission
stay f32, metallic+roughness and ior+transmission are f16-packed into single
u32 words (low|high<<16), KHR_materials_specular / _volume /
_pbrSpecularGlossiness fields, a material_type discriminator
(0=metallic-roughness, 1=specular-glossiness) and 8 texture-index slots
(0xFFFFFFFF = none). Stored as SoA jnp arrays instead of an array-of-structs —
the layout for vectorised shading.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.f16 import pack_f16_pair
from ..utils.pytree import pytree_dataclass

NO_TEXTURE = np.uint32(0xFFFFFFFF)

# Fixed texture-slot assignment within Material::texture_indices[8]. The
# reference packs whichever textures exist into consecutive slots
# (src/gltf_loader.rs:450-486) — workable only because its
# kernel never samples them; fixed slots make the indices actually usable.
TEX_BASE_COLOR = 0          # baseColorTexture / spec-gloss diffuseTexture
TEX_METALLIC_ROUGHNESS = 1  # metallicRoughnessTexture (B=metal, G=rough)
TEX_NORMAL = 2              # normalTexture
TEX_OCCLUSION = 3           # occlusionTexture (R)
TEX_EMISSIVE = 4            # emissiveTexture
TEX_SG_SPECGLOSS = 5        # spec-gloss specularGlossinessTexture


@pytree_dataclass(meta_fields=("present_slots",))
class Materials:
    albedo: jnp.ndarray               # [M,3] f32
    metallic_roughness_f16: jnp.ndarray  # [M] u32: metallic | roughness<<16
    emission: jnp.ndarray             # [M,3] f32
    ior_transmission_f16: jnp.ndarray  # [M] u32: ior | transmission<<16
    specular_factor: jnp.ndarray      # [M] f32 (KHR_materials_specular)
    specular_color: jnp.ndarray       # [M,3] f32
    attenuation_distance: jnp.ndarray  # [M] f32 (KHR_materials_volume)
    attenuation_color: jnp.ndarray    # [M,3] f32
    thickness_factor: jnp.ndarray     # [M] f32
    diffuse_factor: jnp.ndarray       # [M,3] f32 (KHR_materials_pbrSpecularGlossiness)
    glossiness_factor: jnp.ndarray    # [M] f32
    material_type: jnp.ndarray        # [M] u32: 0=metallic-roughness 1=spec-gloss
    texture_indices: jnp.ndarray      # [M,8] u32
    # STATIC (jit-cache key): which texture slots any material actually uses
    # — lets shading skip whole sampling passes for absent maps at trace
    # time. None = unknown, treat every samplable slot as present.
    present_slots: tuple = None

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


class MaterialBuilder:
    """Host-side accumulator producing a `Materials` SoA."""

    def __init__(self):
        self._rows: list[dict] = []

    def __len__(self) -> int:
        return len(self._rows)

    def add(
        self,
        albedo=(1.0, 1.0, 1.0),
        metallic: float = 0.0,
        roughness: float = 1.0,
        emission=(0.0, 0.0, 0.0),
        ior: float = 1.5,
        transmission: float = 0.0,
        specular_factor: float = 1.0,
        specular_color=(1.0, 1.0, 1.0),
        attenuation_distance: float = float("inf"),
        attenuation_color=(1.0, 1.0, 1.0),
        thickness_factor: float = 0.0,
        diffuse_factor=None,
        glossiness_factor=None,
        material_type: int = 0,
        texture_indices=None,
    ) -> int:
        """Material::new semantics (shared/src/lib.rs:254-312):
        diffuse_factor defaults to albedo, glossiness to 1-roughness."""
        row = dict(
            albedo=np.asarray(albedo, np.float32),
            metallic_roughness_f16=pack_f16_pair(metallic, roughness),
            emission=np.asarray(emission, np.float32),
            ior_transmission_f16=pack_f16_pair(ior, transmission),
            specular_factor=np.float32(specular_factor),
            specular_color=np.asarray(specular_color, np.float32),
            attenuation_distance=np.float32(attenuation_distance),
            attenuation_color=np.asarray(attenuation_color, np.float32),
            thickness_factor=np.float32(thickness_factor),
            diffuse_factor=np.asarray(
                albedo if diffuse_factor is None else diffuse_factor, np.float32
            ),
            # the default derives from the f16-QUANTISED roughness: a GLB
            # round trip re-derives it from the decoded f16 value
            # (gltf.py), so using the raw f32 here would differ by an f16
            # rounding for no reason (the value is unused in MR mode)
            glossiness_factor=np.float32(
                (1.0 - np.float32(np.float16(roughness)))
                if glossiness_factor is None else glossiness_factor
            ),
            material_type=np.uint32(material_type),
            texture_indices=np.full(8, NO_TEXTURE, np.uint32)
            if texture_indices is None
            else np.asarray(texture_indices, np.uint32),
        )
        self._rows.append(row)
        return len(self._rows) - 1

    # Convenience constructors matching shared/src/lib.rs:314-346
    def add_diffuse(self, albedo) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=1.0)

    def add_metallic(self, albedo, roughness: float) -> int:
        return self.add(albedo=albedo, metallic=1.0, roughness=roughness)

    def add_glass(self, albedo, ior: float, transmission: float) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=0.0, ior=ior,
                        transmission=transmission)

    def add_emissive(self, albedo, emission) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=1.0, emission=emission)

    def add_specular_glossiness(self, diffuse, specular, glossiness: float) -> int:
        return self.add(
            albedo=diffuse, metallic=0.0, roughness=1.0 - glossiness,
            material_type=1, diffuse_factor=diffuse, specular_color=specular,
            glossiness_factor=glossiness,
        )

    def build(self) -> Materials:
        if not self._rows:
            # Always keep at least one (magenta "invalid") material so shading
            # never indexes an empty array.
            self.add(albedo=(1.0, 0.0, 1.0))
        cols = {k: np.stack([r[k] for r in self._rows]) for k in self._rows[0]}
        ti = cols["texture_indices"]
        present = tuple(int(s) for s in range(8)
                        if (ti[:, s] != NO_TEXTURE).any())
        return Materials(**{k: jnp.asarray(v) for k, v in cols.items()},
                         present_slots=present)
