"""Editable scene data model (host side).

This is the rebuild of the reference's scene contract
(`code/include/scene/*.hpp` in civilizwa/nrenderer): plain Python dataclasses
that the importers (`.scn` / `.obj`) populate and that `scene.arrays.build_scene_arrays`
flattens into SoA jnp arrays for the jitted renderers.

Mapping to the reference:
  - Material / Property        -> reference `Material.hpp:21-168` (typed key/value props)
  - Texture                    -> `Texture.hpp:12-39`
  - Sphere/Triangle/Plane/Mesh -> `Model.hpp:17-104`
  - Node / Model               -> `Model.hpp:60-104` (tagged union into buffers)
  - Light + 4 light structs    -> `Light.hpp:15-67`
  - Camera                     -> `Camera.hpp:13-48` (same defaults)
  - RenderOption               -> `Scene.hpp:13-27` (UI defaults from
                                  `RenderSettingsManager.hpp:20-24`: depth=20)
  - Ambient                    -> `Scene.hpp:29-38`
  - Scene                      -> `Scene.hpp:40-66` (flat buffers)

Handles: the reference uses 1-based nullable `Handle` (`vec.hpp:13-27`).  Here we
use plain 0-based ints with -1 for "invalid" — idiomatic for array indexing.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

Vec3 = Tuple[float, float, float]
Vec4 = Tuple[float, float, float, float]

INVALID = -1  # null handle


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

class PropertyType(enum.Enum):
    INT = "Int"
    FLOAT = "Float"
    RGB = "RGB"
    RGBA = "RGBA"
    VEC3 = "Vec3"
    VEC4 = "Vec4"
    TEXTURE_ID = "Texture"


@dataclass
class Property:
    """Typed key/value material property (reference `Material.hpp:21-90`)."""
    key: str
    type: PropertyType
    value: Union[int, float, Vec3, Vec4]


@dataclass
class Material:
    """Open material: integer `type` whose meaning is per-renderer, plus a
    property list with dedup-by-key registration (`Material.hpp:92-168`)."""
    name: str = ""
    type: int = 0
    properties: List[Property] = field(default_factory=list)

    def register_property(self, prop: Property) -> bool:
        """Add a property; duplicate keys are rejected (reference semantics:
        `Material::registerProperty` dedups by key)."""
        for p in self.properties:
            if p.key == prop.key:
                return False
        self.properties.append(prop)
        return True

    def remove_property(self, key: str) -> bool:
        for i, p in enumerate(self.properties):
            if p.key == key:
                del self.properties[i]
                return True
        return False

    def get_property(self, key: str, ptype: Optional[PropertyType] = None):
        for p in self.properties:
            if p.key == key and (ptype is None or p.type == ptype):
                return p.value
        return None


@dataclass
class Texture:
    """RGBA float image in [0,1], shape (H, W, 4) (reference `Texture.hpp`)."""
    name: str = ""
    pixels: Optional[np.ndarray] = None  # (H, W, 4) float32

    @property
    def width(self) -> int:
        return 0 if self.pixels is None else self.pixels.shape[1]

    @property
    def height(self) -> int:
        return 0 if self.pixels is None else self.pixels.shape[0]


# ---------------------------------------------------------------------------
# Geometry entities
# ---------------------------------------------------------------------------

@dataclass
class Sphere:
    position: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 1.0
    direction: Vec3 = (0.0, 0.0, 1.0)
    material: int = INVALID


@dataclass
class Triangle:
    v1: Vec3 = (0.0, 0.0, 0.0)
    v2: Vec3 = (0.0, 0.0, 0.0)
    v3: Vec3 = (0.0, 0.0, 0.0)
    normal: Optional[Vec3] = None  # if None, computed as cross(v2-v1, v3-v1)
    material: int = INVALID

    def computed_normal(self) -> np.ndarray:
        if self.normal is not None:
            return np.asarray(self.normal, dtype=np.float64)
        e1 = np.asarray(self.v2) - np.asarray(self.v1)
        e2 = np.asarray(self.v3) - np.asarray(self.v1)
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else n


@dataclass
class Plane:
    """Parallelogram patch: position + edge vectors u, v (reference `Model.hpp`)."""
    normal: Vec3 = (0.0, 1.0, 0.0)
    position: Vec3 = (0.0, 0.0, 0.0)
    u: Vec3 = (1.0, 0.0, 0.0)
    v: Vec3 = (0.0, 0.0, 1.0)
    material: int = INVALID


@dataclass
class Mesh:
    """Indexed triangle mesh (reference `Model.hpp:75-86`)."""
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    position_indices: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    normal_indices: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    uv_indices: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    material: int = INVALID


class NodeType(enum.Enum):
    SPHERE = 0
    TRIANGLE = 1
    PLANE = 2
    MESH = 3


@dataclass
class Node:
    """Tagged reference into one of the four entity buffers (`Model.hpp:60-71`)."""
    name: str = ""
    type: NodeType = NodeType.SPHERE
    entity: int = INVALID  # index into the per-type buffer
    model: int = INVALID   # owning model index


@dataclass
class Model:
    name: str = ""
    nodes: List[int] = field(default_factory=list)  # indices into Scene.nodes
    translation: Vec3 = (0.0, 0.0, 0.0)
    scale: Vec3 = (1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------

class LightType(enum.Enum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2
    AREA = 3


@dataclass
class Light:
    name: str = ""
    type: LightType = LightType.POINT
    entity: int = INVALID


@dataclass
class AreaLight:
    radiance: Vec3 = (1.0, 1.0, 1.0)
    position: Vec3 = (0.0, 0.0, 0.0)
    u: Vec3 = (0.0, 0.0, 0.0)
    v: Vec3 = (0.0, 0.0, 0.0)


@dataclass
class PointLight:
    intensity: Vec3 = (1.0, 1.0, 1.0)
    position: Vec3 = (0.0, 0.0, 0.0)


@dataclass
class DirectionalLight:
    irradiance: Vec3 = (1.0, 1.0, 1.0)
    direction: Vec3 = (0.0, 0.0, -1.0)


@dataclass
class SpotLight:
    intensity: Vec3 = (1.0, 1.0, 1.0)
    position: Vec3 = (0.0, 0.0, 0.0)
    direction: Vec3 = (0.0, 0.0, -1.0)
    hot_spot: float = np.pi / 4
    fallout: float = np.pi / 3


# ---------------------------------------------------------------------------
# Camera / options / ambient
# ---------------------------------------------------------------------------

@dataclass
class Camera:
    """Same defaults as reference `Camera.hpp:22-29`."""
    position: Vec3 = (0.0, 0.0, 10.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    look_at: Vec3 = (0.0, 0.0, 1000.0)
    fov: float = 40.0
    aperture: float = 0.0
    focus_distance: float = 0.1
    aspect: float = 1.0


@dataclass
class RenderOption:
    """UI defaults (`RenderSettingsManager.hpp:20-24`: depth=20, spp=16, 500x500).

    `acc_type` and the global material knobs (roughness/f0/metalness)
    mirror the reference's `RenderOption`/`RenderSettings` fields
    (`Scene.hpp:13-27`, `RenderSettingsManager.hpp:9-29`).  The reference's
    shipped shaders never read its globals; here a knob set to a non-None
    value OVERRIDES the per-material microfacet parameter for every
    material (`scene/arrays._pack_material`), making the config surface
    live.  None (the default) keeps the per-material/reference-constant
    behavior.

    The reference's fourth global, `shadeType` (`RenderSettingsManager.hpp:18`),
    is deliberately NOT carried: no reference renderer reads it either, and
    shading dispatch in this rebuild (as in the reference's shipped
    shaders) is per-material `Material.type`, so a global shade switch has
    no consumer to wire to."""
    width: int = 500
    height: int = 500
    depth: int = 20
    samples_per_pixel: int = 16
    acc_type: int = 1
    roughness: Optional[float] = None
    f0: Optional[float] = None
    metalness: Optional[float] = None


class AmbientType(enum.Enum):
    CONSTANT = 0
    ENVIRONMENT_MAP = 1


@dataclass
class Ambient:
    type: AmbientType = AmbientType.CONSTANT
    constant: Vec3 = (0.0, 0.0, 0.0)
    environment_map: int = INVALID  # texture index


# ---------------------------------------------------------------------------
# Scene (flat snapshot, the contract handed to renderers)
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    """Flat SoA-style buffers, mirroring reference `Scene.hpp:40-66`."""
    camera: Camera = field(default_factory=Camera)
    render_option: RenderOption = field(default_factory=RenderOption)
    ambient: Ambient = field(default_factory=Ambient)

    materials: List[Material] = field(default_factory=list)
    textures: List[Texture] = field(default_factory=list)

    models: List[Model] = field(default_factory=list)
    nodes: List[Node] = field(default_factory=list)
    sphere_buffer: List[Sphere] = field(default_factory=list)
    triangle_buffer: List[Triangle] = field(default_factory=list)
    plane_buffer: List[Plane] = field(default_factory=list)
    mesh_buffer: List[Mesh] = field(default_factory=list)

    lights: List[Light] = field(default_factory=list)
    point_light_buffer: List[PointLight] = field(default_factory=list)
    area_light_buffer: List[AreaLight] = field(default_factory=list)
    directional_light_buffer: List[DirectionalLight] = field(default_factory=list)
    spot_light_buffer: List[SpotLight] = field(default_factory=list)

    def material_index(self, name: str) -> int:
        for i, m in enumerate(self.materials):
            if m.name == name:
                return i
        return INVALID
