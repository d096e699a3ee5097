"""Scene-editor tests: the headless AssetView analogue
(reference `AssetView.cpp:158-641` — the ImGui panel that edits camera /
materials / entities / lights in place and re-renders).

Covers the document round-trip, coerced write-back with validation, the
HTTP surface (`GET/POST /scene`), and an end-to-end edit -> re-render loop
through the CLI plumbing.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

from nrenderer_tpu.io.scn import load_scn
from nrenderer_tpu.scene.model import (AmbientType, PropertyType, Scene)
from nrenderer_tpu.server.editor import (EditError, SceneEditor, apply_doc,
                                         scene_doc)

from nrenderer_tpu.resources import RESOURCE_DIR

RES = str(RESOURCE_DIR)


@pytest.fixture()
def cornel():
    return load_scn(f"{RES}/path_tracing_cornel.scn")


# ---------------------------------------------------------------------------
# document round-trip + apply
# ---------------------------------------------------------------------------

def test_doc_roundtrip_is_noop(cornel):
    doc = scene_doc(cornel)
    # the doc must be plain JSON
    doc2 = json.loads(json.dumps(doc))
    assert apply_doc(cornel, doc2) == []


def test_doc_covers_scene_surface(cornel):
    doc = scene_doc(cornel)
    assert doc["camera"]["fov"] == cornel.camera.fov
    assert doc["render_option"]["samples_per_pixel"] == \
        cornel.render_option.samples_per_pixel
    assert len(doc["materials"]) == len(cornel.materials)
    assert len(doc["triangles"]) == len(cornel.triangle_buffer)
    assert doc["ambient"]["type"] in ("CONSTANT", "ENVIRONMENT_MAP")


def test_apply_camera_and_option(cornel):
    doc = scene_doc(cornel)
    doc["camera"]["fov"] = 55.0
    doc["camera"]["position"] = [0.0, 1.0, 9.0]
    doc["render_option"]["samples_per_pixel"] = 4
    changed = apply_doc(cornel, doc)
    assert set(changed) == {"camera.fov", "camera.position",
                            "render_option.samples_per_pixel"}
    assert cornel.camera.fov == 55.0
    assert cornel.camera.position == (0.0, 1.0, 9.0)  # tuple, not list
    assert isinstance(cornel.camera.position, tuple)
    assert cornel.render_option.samples_per_pixel == 4


def test_apply_material_property_preserves_type(cornel):
    doc = scene_doc(cornel)
    # find a material with a diffuseColor property
    idx = next(i for i, m in enumerate(doc["materials"])
               if "diffuseColor" in m["properties"])
    doc["materials"][idx]["properties"]["diffuseColor"] = [0.9, 0.1, 0.2]
    changed = apply_doc(cornel, doc)
    assert changed == [f"materials[{idx}].properties.diffuseColor"]
    prop = next(p for p in cornel.materials[idx].properties
                if p.key == "diffuseColor")
    assert prop.type == PropertyType.RGB
    assert prop.value == (0.9, 0.1, 0.2)


def test_add_and_remove_property(cornel):
    doc = scene_doc(cornel)
    doc["materials"][0]["properties"]["roughness"] = 0.25
    changed = apply_doc(cornel, doc)
    assert "materials[0].properties.roughness" in changed
    assert cornel.materials[0].get_property("roughness") == 0.25
    # null deletes (the panel's remove button)
    doc = scene_doc(cornel)
    doc["materials"][0]["properties"]["roughness"] = None
    apply_doc(cornel, doc)
    assert cornel.materials[0].get_property("roughness") is None


def test_partial_doc_ok(cornel):
    old_fov = cornel.camera.fov
    changed = apply_doc(cornel, {"camera": {"aperture": 0.5}})
    assert changed == ["camera.aperture"]
    assert cornel.camera.fov == old_fov


def test_validation_errors(cornel):
    with pytest.raises(EditError):  # wrong arity for a vec3
        apply_doc(cornel, {"camera": {"position": [1.0, 2.0]}})
    with pytest.raises(EditError):  # entity add/remove unsupported
        apply_doc(cornel, {"spheres": [{}] * (len(cornel.sphere_buffer) + 1)})
    with pytest.raises(EditError):  # bad ambient enum
        apply_doc(cornel, {"ambient": {"type": "NOPE"}})
    with pytest.raises(EditError):  # env-map ambient without a map loaded
        scene = Scene()
        apply_doc(scene, {"ambient": {"type": "ENVIRONMENT_MAP"}})
    # out-of-range material binding is rejected
    doc = scene_doc(cornel)
    if doc["triangles"]:
        doc["triangles"][0]["material"] = 999
        with pytest.raises(EditError):
            apply_doc(cornel, doc)


def test_light_edit(cornel):
    doc = scene_doc(cornel)
    kinds = [k for k, v in doc["lights"].items() if v]
    if not kinds:
        pytest.skip("scene has no lights")
    kind = kinds[0]
    field = next(iter(doc["lights"][kind][0]))
    val = doc["lights"][kind][0][field]
    doc["lights"][kind][0][field] = ([v + 0.5 for v in val]
                                     if isinstance(val, list) else val + 0.5)
    changed = apply_doc(cornel, doc)
    assert changed == [f"lights.{kind}[0].{field}"]


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_editor_http_surface(cornel):
    from nrenderer_tpu.server.screen import Screen
    from nrenderer_tpu.server.viewer import ScreenViewer

    editor = SceneEditor(cornel)
    viewer = ScreenViewer(Screen(), port=0, routes=editor.routes).start()
    try:
        # root page is the editor panel, not the plain viewer
        _, page = _get(viewer.url)
        assert b"apply + re-render" in page
        # GET /scene
        _, body = _get(viewer.url + "scene")
        payload = json.loads(body)
        assert payload["version"] == 0
        doc = payload["doc"]
        # POST an edit -> applied + dirty
        doc["camera"]["fov"] = 33.0
        code, body = _post(viewer.url + "scene",
                           json.dumps(doc).encode())
        assert code == 200
        resp = json.loads(body)
        assert resp["changed"] == ["camera.fov"]
        assert resp["version"] == 1
        assert cornel.camera.fov == 33.0
        assert editor.wait_dirty(timeout=1.0)
        # a no-op POST does not set dirty or bump the version
        code, body = _post(viewer.url + "scene", json.dumps(doc).encode())
        assert json.loads(body)["changed"] == []
        assert not editor.wait_dirty(timeout=0.1)
        # malformed JSON and invalid edits -> 400 with an error message
        code, body = _post(viewer.url + "scene", b"{nope")
        assert code == 400 and b"bad JSON" in body
        code, body = _post(viewer.url + "scene",
                           json.dumps({"camera": {"fov": [1, 2]}}).encode())
        assert code == 400
        assert not editor.wait_dirty(timeout=0.05)
    finally:
        viewer.stop()


# ---------------------------------------------------------------------------
# end-to-end: edit -> re-render through the CLI loop
# ---------------------------------------------------------------------------

def test_edit_loop_rerenders(tmp_path, monkeypatch):
    """Drive `nrenderer_tpu edit` like a browser: wait for the first
    RayCast frame, flip a wall color over POST /scene, and check the
    re-rendered frame actually changed."""
    import re
    import sys
    import time as _time
    from nrenderer_tpu.cli import main

    out = tmp_path / "edit.png"
    url_holder = {}
    orig_stderr = sys.stderr

    class Tee:
        def write(self, s):
            m = re.search(r"http://localhost:\d+/", s)
            if m and "url" not in url_holder:
                url_holder["url"] = m.group(0)
            return orig_stderr.write(s)

        def flush(self):
            orig_stderr.flush()

    monkeypatch.setattr(sys, "stderr", Tee())

    rc_holder = {}

    def run():
        rc_holder["rc"] = main([
            "edit", "--scene", f"{RES}/ray_cast_cornel.scn",
            "--renderer", "RayCast", "--width", "24", "--height", "24",
            "--out", str(out)])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # wait for the first rendered frame
    deadline = _time.time() + 120
    while _time.time() < deadline:
        if "url" in url_holder:
            try:
                st = json.loads(_get(url_holder["url"] + "status")[1])
                if st["frame"] >= 1:
                    break
            except OSError:
                pass
        _time.sleep(0.2)
    else:
        pytest.fail("first frame never arrived")
    url = url_holder["url"]
    _, f1 = _get(url + "frame.png")

    # edit: brighten every diffuse material to pure white
    payload = json.loads(_get(url + "scene")[1])
    doc = payload["doc"]
    for m in doc["materials"]:
        if "diffuseColor" in m["properties"]:
            m["properties"]["diffuseColor"] = [1.0, 1.0, 1.0]
    code, body = _post(url + "scene", json.dumps(doc).encode())
    assert code == 200 and json.loads(body)["changed"]

    # wait for the re-render (frame counter moves again)
    frame0 = json.loads(_get(url + "status")[1])["frame"]
    deadline = _time.time() + 120
    while _time.time() < deadline:
        st = json.loads(_get(url + "status")[1])
        if st["frame"] > frame0:
            break
        _time.sleep(0.2)
    else:
        pytest.fail("re-render never arrived")
    _, f2 = _get(url + "frame.png")
    assert f1 != f2  # the edit is visible

    # decoded frames: the whitened walls are brighter on average
    p1, p2 = tmp_path / "f1.png", tmp_path / "f2.png"
    p1.write_bytes(f1)
    p2.write_bytes(f2)
    from nrenderer_tpu.io.image import read_png
    a, b = read_png(str(p1)), read_png(str(p2))
    assert b.mean() > a.mean()


# ---------------------------------------------------------------------------
# structural adds (the panel's "add node" / "add light" buttons)
# ---------------------------------------------------------------------------

def test_add_sphere_wires_node(cornel):
    n_nodes = len(cornel.nodes)
    n_spheres = len(cornel.sphere_buffer)
    doc = {"spheres": [{} for _ in range(n_spheres)] + [
        {"position": [1.0, 2.0, 3.0], "radius": 0.5, "material": 0,
         "model": 0, "name": "ball"}]}
    changed = apply_doc(cornel, doc)
    assert f"spheres[{n_spheres}] (added)" in changed
    assert len(cornel.sphere_buffer) == n_spheres + 1
    s = cornel.sphere_buffer[-1]
    assert s.position == (1.0, 2.0, 3.0) and s.radius == 0.5
    node = cornel.nodes[-1]
    assert len(cornel.nodes) == n_nodes + 1
    assert node.entity == n_spheres and node.model == 0
    assert (n_nodes) in cornel.models[0].nodes
    # the scene still flattens (arrays sees the new entity)
    from nrenderer_tpu.scene.arrays import build_scene_arrays
    arr = build_scene_arrays(cornel)
    assert arr.sph_pos.shape[0] == n_spheres + 1


def test_add_entity_requires_material(cornel):
    n = len(cornel.sphere_buffer)
    with pytest.raises(EditError):
        apply_doc(cornel, {"spheres": [{}] * n + [{"radius": 1.0}]})


def test_add_point_light(cornel):
    n = len(cornel.point_light_buffer)
    n_lights = len(cornel.lights)
    doc = {"lights": {"point": [{} for _ in range(n)] + [
        {"intensity": [2.0, 2.0, 2.0], "position": [0.0, 1.0, 0.0]}]}}
    changed = apply_doc(cornel, doc)
    assert f"lights.point[{n}] (added)" in changed
    assert len(cornel.point_light_buffer) == n + 1
    assert cornel.point_light_buffer[-1].intensity == (2.0, 2.0, 2.0)
    assert len(cornel.lights) == n_lights + 1
    assert cornel.lights[-1].entity == n


def test_remove_entry_rejected(cornel):
    if not cornel.triangle_buffer:
        pytest.skip("no triangles")
    with pytest.raises(EditError):
        apply_doc(cornel, {"triangles": []})


def test_optional_knob_set_and_reset(cornel):
    """roughness/f0/metalness are Optional[float]: settable AND resettable
    to null (advisor: the override must not be sticky for the session)."""
    apply_doc(cornel, {"render_option": {"roughness": 0.4}})
    assert cornel.render_option.roughness == 0.4
    apply_doc(cornel, {"render_option": {"roughness": None}})
    assert cornel.render_option.roughness is None


def test_bad_material_type_is_edit_error(cornel):
    docs = [{} for _ in cornel.materials]
    docs[0] = {"type": "not-an-int"}
    with pytest.raises(EditError):
        apply_doc(cornel, {"materials": docs})


def test_bad_model_index_type_is_edit_error(cornel):
    n = len(cornel.sphere_buffer)
    doc = {"spheres": [{} for _ in range(n)] + [
        {"radius": 1.0, "material": 0, "model": "zero"}]}
    with pytest.raises(EditError):
        apply_doc(cornel, doc)


def test_snapshot_is_isolated(cornel):
    """The render loop traces a snapshot; later edits must not leak in."""
    from nrenderer_tpu.server.editor import SceneEditor
    ed = SceneEditor(cornel)
    snap, v0 = ed.snapshot()
    assert snap is not cornel
    old_fov = cornel.camera.fov
    apply_doc(cornel, {"camera": {"fov": old_fov + 5.0}})
    assert snap.camera.fov == old_fov
    assert cornel.camera.fov == old_fov + 5.0


# ---------------------------------------------------------------------------
# AssetView parity: removal / templates / texture import / preview
# (reference AssetView.cpp:158-641, ScreenView.cpp:11-52)
# ---------------------------------------------------------------------------

def test_remove_sphere_compacts_nodes(cornel):
    from nrenderer_tpu.scene.model import NodeType
    ns, nn = len(cornel.sphere_buffer), len(cornel.nodes)
    nt = len(cornel.triangle_buffer)
    changed = apply_doc(cornel, {"spheres": [None] + [{}] * (ns - 1)})
    assert changed == ["spheres[0] (removed)"]
    assert len(cornel.sphere_buffer) == ns - 1
    assert len(cornel.nodes) == nn - 1
    # no dangling or skipped entity indices per type
    for ntype, buf in ((NodeType.SPHERE, cornel.sphere_buffer),
                       (NodeType.TRIANGLE, cornel.triangle_buffer)):
        ents = sorted(nd.entity for nd in cornel.nodes if nd.type is ntype)
        assert ents == list(range(len(buf)))
    # model node lists reference valid node slots
    for mdl in cornel.models:
        assert all(0 <= k < len(cornel.nodes) for k in mdl.nodes)
    assert len(cornel.triangle_buffer) == nt
    # scene still flattens
    from nrenderer_tpu.scene.arrays import build_scene_arrays
    build_scene_arrays(cornel)


def test_remove_light(cornel):
    na = len(cornel.area_light_buffer)
    nl = len(cornel.lights)
    if na == 0:
        pytest.skip("no area lights")
    changed = apply_doc(cornel, {"lights": {"area": [None] + [{}] * (na - 1)}})
    assert changed == ["lights.area[0] (removed)"]
    assert len(cornel.area_light_buffer) == na - 1
    assert len(cornel.lights) == nl - 1


def test_material_from_template_and_removal(cornel):
    n = len(cornel.materials)
    doc = {"materials": [{}] * n + [
        {"template": "Dielectric", "name": "glassy",
         "properties": {"ior": 1.33}}]}
    changed = apply_doc(cornel, doc)
    assert f"materials[{n}] (added)" in changed
    m = cornel.materials[-1]
    assert m.type == 2 and m.name == "glassy"
    assert m.get_property("ior") == 1.33
    assert m.get_property("absorbed") == (1.0, 1.0, 1.0)  # template default
    # unknown template -> EditError
    with pytest.raises(EditError):
        apply_doc(cornel, {"materials": [{}] * (n + 1)
                           + [{"template": "Nope"}]})
    # removal of the unbound material
    changed = apply_doc(cornel, {"materials": [{}] * n + [None]})
    assert changed == [f"materials[{n}] (removed)"]
    assert len(cornel.materials) == n


def test_remove_bound_material_rejected(cornel):
    n = len(cornel.materials)
    with pytest.raises(EditError):
        apply_doc(cornel, {"materials": [None] + [{}] * (n - 1)})
    assert len(cornel.materials) == n


def test_material_removal_renumbers_bindings(cornel):
    """Removing material i decrements every binding > i."""
    n = len(cornel.materials)
    # add an unbound material at index n, then bind a new sphere to n+1
    apply_doc(cornel, {"materials": [{}] * n + [
        {"template": "Lambertian", "name": "tmp"},
        {"template": "Conductor", "name": "shiny"}]})
    ns = len(cornel.sphere_buffer)
    apply_doc(cornel, {"spheres": [{}] * ns + [
        {"radius": 1.0, "material": n + 1}]})
    # remove the unbound one at n; the sphere's binding must follow
    apply_doc(cornel, {"materials": [{}] * n + [None, {}]})
    assert cornel.sphere_buffer[-1].material == n
    assert cornel.materials[n].name == "shiny"


def test_texture_import(cornel, tmp_path):
    import numpy as np
    from nrenderer_tpu.io.image import write_png
    png = tmp_path / "tex.png"
    write_png(str(png), np.full((4, 4, 3), 0.5, np.float32))
    nt = len(cornel.textures)
    doc = scene_doc(cornel)
    doc["textures"].append({"name": "mytex", "path": str(png)})
    changed = apply_doc(cornel, doc)
    assert changed == [f"textures[{nt}] (imported)"]
    t = cornel.textures[-1]
    assert t.name == "mytex" and t.pixels.shape == (4, 4, 4)
    # bad path -> EditError
    with pytest.raises(EditError):
        apply_doc(cornel, {"textures": [{}] * (nt + 1)
                           + [{"name": "x", "path": "/nope.png"}]})


def test_geometry_preview(cornel):
    import numpy as np
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.renderers.preview import GeometryPreviewRenderer
    cornel.render_option.width = 600
    cornel.render_option.height = 300
    r = GeometryPreviewRenderer().render(cornel)
    # capped + aspect preserved
    assert (r.width, r.height) == (256, 128)
    img = np.asarray(r.pixels)
    assert np.isfinite(img).all()
    # the light patch shows as near-white pixels, geometry as mid tones
    assert (img[..., :3].min(axis=2) > 0.95).any()
    lit = img[..., :3].sum(axis=2)
    assert ((lit > 0.5) & (lit < 2.8)).mean() > 0.3


def test_preview_decimation_keeps_small_meshes():
    from nrenderer_tpu.renderers.preview import preview_scene
    from nrenderer_tpu.io.scn import load_scn
    from nrenderer_tpu.io.obj import load_obj
    s = load_scn(f"{RES}/path_tracing_cornel.scn")
    assert preview_scene(s) is s  # no meshes -> shared
    load_obj(f"{RES}/obj/bunny_5k_faces.obj", s, material=0)
    ps = preview_scene(s)
    assert ps is not s
    faces = len(ps.mesh_buffer[-1].position_indices) // 3
    assert 0 < faces <= 1024
    # original untouched
    assert len(s.mesh_buffer[-1].position_indices) // 3 > 4000


def test_add_then_remove_roundtrip(cornel):
    """The VERDICT round-trip: add -> edit -> remove -> template -> preview."""
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.renderers.preview import GeometryPreviewRenderer
    ns, nn = len(cornel.sphere_buffer), len(cornel.nodes)
    nm = len(cornel.materials)
    # add a templated material + a sphere bound to it
    apply_doc(cornel, {"materials": [{}] * nm + [
        {"template": "Conductor", "name": "chrome"}]})
    apply_doc(cornel, {"spheres": [{}] * ns + [
        {"position": [0.0, 0.0, 5.0], "radius": 0.5, "material": nm}]})
    # edit it
    apply_doc(cornel, {"spheres": [{}] * ns + [{"radius": 0.75}]})
    assert cornel.sphere_buffer[-1].radius == 0.75
    # preview renders the edited scene
    cornel.render_option.width = cornel.render_option.height = 64
    r = GeometryPreviewRenderer().render(cornel)
    assert r.width == 64
    # remove the sphere, then the material
    apply_doc(cornel, {"spheres": [{}] * ns + [None]})
    apply_doc(cornel, {"materials": [{}] * nm + [None]})
    assert len(cornel.sphere_buffer) == ns
    assert len(cornel.nodes) == nn
    assert len(cornel.materials) == nm
