"""Wavefront OBJ (+ MTL subset) importer.

Reimplements the capability of the reference's `ObjImporter`
(`code/app/src/importer/ObjImporter.cpp:1-421` in civilizwa/nrenderer):

  - directives: `mtllib`, `usemtl`, `v`, `vt`, `vn`, `o`/`g`, `f`
  - `f` variants: ``v``, ``v/t``, ``v//n``, ``v/t/n`` — triangulated faces only
    (the reference raises "Only Triangulated mesh is supported!")
  - per-object index remapping: global OBJ indices are compacted into
    per-mesh position/uv/normal pools (reference `ObjImporter.cpp:192-196`)
  - MTL subset: `newmtl`, `Kd`, `Ks`, `Ns`, `map_Kd`, `map_Ks`,
    `map_bump`/`bump` -> a Phong-typed material (type=1,
    `ObjImporter.cpp:52-61`); unknown keys ignored.  `map_Kd` feeds the
    diffuse lobes and `map_Ks` the specular lobes (conductor/microfacet/
    plastic albedo) — the reference loads both but never samples either;
    `map_bump` is stored (`bumpMap` property + mat_params column) for
    parity but not yet shaded.

All buffers land in the same Scene structures the `.scn` parser fills, so the
two importers compose (reference `SceneImporterFactory`)."""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..scene.model import (
    Material, Mesh, Model, Node, NodeType, Property, PropertyType, Scene,
    Texture,
)
from .image import ImageDecodeError, load_image


class ObjParseError(Exception):
    pass


def _parse_face_vertex(tok: str):
    """Return (v, t, n) 1-based indices; absent -> -1. Mirrors the reference's
    first/last '/' split (`ObjImporter.cpp:322-339`)."""
    first = tok.find("/")
    last = tok.rfind("/")
    try:
        if first == -1:
            return int(tok), -1, -1
        if first == last:
            a, b = tok.split("/")
            return int(a), int(b), -1
        if first + 1 == last:
            a, _, c = tok.split("/")
            return int(a), -1, int(c)
        a, b, c = tok.split("/")
        return int(a), int(b), int(c)
    except ValueError as exc:
        raise ObjParseError(f"Bad face vertex: {tok!r}") from exc


def _load_map(scene: Scene, mtl_path: str, tex_name: str,
              material: Material, prop_name: str) -> None:
    """Decode a texture referenced from an MTL line and attach it to
    `material` as a TEXTURE_ID property; silently skipped when the image
    is missing/undecodable (reference behavior for a bad stb load)."""
    tex_path = os.path.join(os.path.dirname(mtl_path), tex_name)
    try:
        pixels = load_image(tex_path)
    except ImageDecodeError:
        return
    tex_idx = len(scene.textures)
    scene.textures.append(
        Texture(name=os.path.basename(tex_path), pixels=pixels))
    material.register_property(Property(
        prop_name, PropertyType.TEXTURE_ID, tex_idx))


def _parse_mtl(scene: Scene, path: str, mtl_map: Dict[str, int]) -> None:
    if not os.path.exists(path):
        return  # reference silently skips a missing .mtl
    current: Optional[Material] = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0].lower()
            if key == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                # Lambertian until a nonzero Ks appears: type 1 means
                # Phong to RayCast but CONDUCTOR to the acc plugin
                # (`acc/ShaderCreator.hpp:25-27`), so a diffuse-only MTL
                # tagged Phong would render black in the path tracers
                current = Material(name=name, type=0)
                mtl_map[name] = len(scene.materials)
                scene.materials.append(current)
            elif current is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                current.register_property(Property(
                    "diffuseColor", PropertyType.RGB,
                    (float(parts[1]), float(parts[2]), float(parts[3]))))
            elif key == "ks" and len(parts) >= 4:
                ks = (float(parts[1]), float(parts[2]), float(parts[3]))
                current.register_property(Property(
                    "specularColor", PropertyType.RGB, ks))
                if any(v > 0.0 for v in ks):
                    current.type = 1  # Phong
            elif key == "ns" and len(parts) >= 2:
                current.register_property(Property(
                    "specularEx", PropertyType.FLOAT, float(parts[1])))
            elif key == "map_kd" and len(parts) >= 2:
                _load_map(scene, path, parts[-1], current, "diffuseMap")
            elif key == "map_ks" and len(parts) >= 2:
                # reference `ObjImporter.cpp:56-58` loads map_Ks the same way
                _load_map(scene, path, parts[-1], current, "specularMap")
            elif key in ("map_bump", "bump") and len(parts) >= 2:
                # reference `ObjImporter.cpp:59-61`; stored, not yet shaded
                _load_map(scene, path, parts[-1], current, "bumpMap")


def _load_obj_native(path: str, scene: Scene,
                     material: Optional[int]) -> Optional[Scene]:
    """Fast path: the native C++ scanner (native/nrnative.cpp) for plain
    triangulated OBJ files (no materials/groups — e.g. the stock bunnies).
    Returns None to fall back to the python parser."""
    from .. import native
    try:
        # Stream the WHOLE file for disqualifying directives (a 64 KB sniff
        # missed usemtl/mtllib appearing late in large files, silently
        # dropping materials — ADVICE r1).  A plain `rb` scan of ~10 MB OBJ
        # takes single-digit ms, negligible next to the triangle parse.
        with open(path, "rb") as f:
            prev_tail = b"\n"  # treat the first line as newline-preceded
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                buf = prev_tail + chunk
                if (b"usemtl" in buf or b"mtllib" in buf or b"\no " in buf
                        or b"\ng " in buf):
                    return None
                prev_tail = buf[-8:]  # overlap so split directives still match
    except OSError:
        return None
    scanned = native.obj_scan(path)
    if scanned is None:
        return None
    v, vt, vn, fv, ft, fn = scanned
    if fv.shape[0] == 0:
        return None
    model = Model(name=os.path.splitext(os.path.basename(path))[0])
    model_idx = len(scene.models)
    scene.models.append(model)
    mesh = Mesh()
    # resolve 1-based (and negative = relative) indices
    nv = v.shape[0]
    pos_idx = np.where(fv < 0, fv + nv, fv - 1).astype(np.int32)
    mesh.positions = v
    mesh.position_indices = pos_idx.reshape(-1)
    if vn.shape[0] and (fn != 0).all():
        mesh.normals = vn
        mesh.normal_indices = np.where(fn < 0, fn + vn.shape[0],
                                       fn - 1).astype(np.int32).reshape(-1)
    if vt.shape[0] and (ft != 0).all():
        mesh.uvs = vt
        mesh.uv_indices = np.where(ft < 0, ft + vt.shape[0],
                                   ft - 1).astype(np.int32).reshape(-1)
    mesh.material = material if material is not None else -1
    node = Node(name="Undefined", type=NodeType.MESH,
                entity=len(scene.mesh_buffer), model=model_idx)
    model.nodes.append(len(scene.nodes))
    scene.nodes.append(node)
    scene.mesh_buffer.append(mesh)
    return scene


def load_obj(path: str, scene: Optional[Scene] = None,
             material: Optional[int] = None) -> Scene:
    """Import an OBJ file into `scene` (or a fresh Scene).

    `material`: optional material index to assign when the OBJ has no
    usemtl/mtllib (the stock bunnies have neither; the reference leaves the
    mesh material handle invalid and the UI assigns one).

    Plain triangulated files take the native C++ scan (nr_obj_parse); files
    with materials or groups use the python parser below."""
    if scene is None:
        scene = Scene()
    native_result = _load_obj_native(path, scene, material)
    if native_result is not None:
        return native_result

    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    mtl_map: Dict[str, int] = {}

    model = Model(name=os.path.splitext(os.path.basename(path))[0])
    model_idx = len(scene.models)
    scene.models.append(model)

    mesh: Optional[Mesh] = None
    # staging pools for the current mesh
    p_map: Dict[int, int] = {}
    t_map: Dict[int, int] = {}
    n_map: Dict[int, int] = {}
    pool_p: List[List[float]] = []
    pool_t: List[List[float]] = []
    pool_n: List[List[float]] = []
    idx_p: List[int] = []
    idx_t: List[int] = []
    idx_n: List[int] = []
    mesh_name = "Undefined"
    current_material = material if material is not None else -1

    def flush_mesh():
        nonlocal mesh
        if mesh is None:
            return
        mesh.positions = np.asarray(pool_p, np.float32).reshape(-1, 3)
        mesh.uvs = np.asarray(pool_t, np.float32).reshape(-1, 2)
        mesh.normals = np.asarray(pool_n, np.float32).reshape(-1, 3)
        mesh.position_indices = np.asarray(idx_p, np.int32)
        mesh.uv_indices = np.asarray(idx_t, np.int32)
        mesh.normal_indices = np.asarray(idx_n, np.int32)
        mesh.material = current_material
        mesh = None

    def start_mesh():
        nonlocal mesh
        p_map.clear(); t_map.clear(); n_map.clear()
        pool_p.clear(); pool_t.clear(); pool_n.clear()
        idx_p.clear(); idx_t.clear(); idx_n.clear()
        mesh = Mesh()
        node = Node(name=mesh_name, type=NodeType.MESH,
                    entity=len(scene.mesh_buffer), model=model_idx)
        model.nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        scene.mesh_buffer.append(mesh)

    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                key = parts[0]
                if key == "v":
                    positions.append([float(x) for x in parts[1:4]])
                elif key == "vt":
                    uvs.append([float(x) for x in parts[1:3]])
                elif key == "vn":
                    normals.append([float(x) for x in parts[1:4]])
                elif key in ("o", "g"):
                    flush_mesh()
                    mesh_name = parts[1] if len(parts) > 1 else "Undefined"
                elif key == "mtllib" and len(parts) > 1:
                    _parse_mtl(scene, os.path.join(os.path.dirname(path),
                                                   parts[1]), mtl_map)
                elif key == "usemtl" and len(parts) > 1:
                    current_material = mtl_map.get(parts[1], current_material)
                elif key == "f":
                    if len(parts) != 4:
                        raise ObjParseError(
                            "Only Triangulated mesh is supported!")
                    if mesh is None:
                        start_mesh()
                    for tok in parts[1:4]:
                        v, t, n = _parse_face_vertex(tok)
                        if v != -1:
                            if v not in p_map:
                                p_map[v] = len(pool_p)
                                pool_p.append(positions[v - 1])
                            idx_p.append(p_map[v])
                        if t != -1:
                            if t not in t_map:
                                t_map[t] = len(pool_t)
                                pool_t.append(uvs[t - 1])
                            idx_t.append(t_map[t])
                        if n != -1:
                            if n not in n_map:
                                n_map[n] = len(pool_n)
                                pool_n.append(normals[n - 1])
                            idx_n.append(n_map[n])
    except OSError as exc:
        raise ObjParseError(f"File does not exist: {path}") from exc

    flush_mesh()
    return scene
