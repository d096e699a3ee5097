""".scn parser tests against the stock reference scenes.

Expected values are those of the stock scenes in `resources/` and
the reference parser's semantics (`ScnImporter.cpp:440-535`)."""
import numpy as np
import pytest

from nrenderer_tpu import (
    AmbientType, LightType, NodeType, PropertyType, Scene, ScnParseError,
    load_scn, parse_scn,
)

ALL_SCENES = [
    "Metropolis.scn", "conductors.scn", "env_map_spheres.scn", "mycornel.scn",
    "path_tracing_cornel.scn", "pt_glass.scn", "ray_cast_cornel.scn",
]


@pytest.mark.parametrize("name", ALL_SCENES)
def test_parses_all_stock_scenes(resource_dir, name):
    scene = load_scn(str(resource_dir / name))
    assert len(scene.materials) > 0
    assert len(scene.nodes) > 0 or name == "conductors.scn"


def test_path_tracing_cornel_contents(resource_dir):
    s = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    assert [m.name for m in s.materials] == ["White", "Red", "Green"]
    # C++ stream semantics: "0.63 0.065, 0.05" parses blue as 0.0
    red = s.materials[1].get_property("diffuseColor", PropertyType.RGB)
    assert red == pytest.approx((0.63, 0.065, 0.0))
    white = s.materials[0].get_property("diffuseColor", PropertyType.RGB)
    assert white == pytest.approx((0.725, 0.71, 0.68))
    # 5 walls + 6 box planes = 11 planes, 1 sphere, 4 triangles
    assert len(s.plane_buffer) == 11
    assert len(s.sphere_buffer) == 1
    assert len(s.triangle_buffer) == 4
    assert len(s.models) == 4
    # model translations
    assert s.models[0].translation == pytest.approx((0.0, 0.0, 1028.0))
    assert s.models[1].translation == pytest.approx((-100.0, -228.0, 800.0))
    # area light
    assert len(s.area_light_buffer) == 1
    al = s.area_light_buffer[0]
    assert al.radiance == pytest.approx((47.8384, 38.5664, 31.0808))
    assert al.position == pytest.approx((60.0, 275.0, 1088.0))
    assert al.u == pytest.approx((-120.0, 0.0, 0.0))
    assert al.v == pytest.approx((0.0, 0.0, -120.0))
    assert s.lights[0].type == LightType.AREA


def test_ray_cast_cornel_contents(resource_dir):
    s = load_scn(str(resource_dir / "ray_cast_cornel.scn"))
    assert [m.name for m in s.materials] == ["White", "Red", "Green", "Phong"]
    assert s.materials[3].type == 1
    assert s.materials[3].get_property("specularEx",
                                       PropertyType.FLOAT) == pytest.approx(10.0)
    assert len(s.point_light_buffer) == 1
    assert s.point_light_buffer[0].position == pytest.approx((0.0, 273.0, 1028.0))
    assert s.point_light_buffer[0].intensity == pytest.approx((1.0, 1.0, 1.0))
    # sphere node uses Phong material (index 3)
    sphere_nodes = [n for n in s.nodes if n.type == NodeType.SPHERE]
    assert len(sphere_nodes) == 1
    assert s.sphere_buffer[0].material == 3
    assert s.sphere_buffer[0].radius == pytest.approx(50.0)


def test_conductors_materials(resource_dir):
    s = load_scn(str(resource_dir / "conductors.scn"))
    assert len(s.materials) == 14
    assert all(m.type == 3 for m in s.materials)
    gold = next(m for m in s.materials if m.name == "Gold")
    assert gold.get_property("reflect", PropertyType.RGB) == \
        pytest.approx((1.0, 0.782, 0.344))


def test_pt_glass_conductor_props(resource_dir):
    s = load_scn(str(resource_dir / "pt_glass.scn"))
    gold = next(m for m in s.materials if m.name == "Gold")
    assert gold.type == 1
    assert gold.get_property("eta_r", PropertyType.VEC3) == \
        pytest.approx((0.142, 0.374, 1.439))
    assert gold.get_property("eta_i", PropertyType.VEC3) == \
        pytest.approx((3.974, 2.380, 1.599))
    assert gold.get_property("albedo", PropertyType.RGB) == \
        pytest.approx((1.0, 0.843, 0.0))


def test_env_map_spheres(resource_dir):
    s = load_scn(str(resource_dir / "env_map_spheres.scn"))
    glass = next(m for m in s.materials if m.name == "Glass")
    assert glass.type == 2
    assert glass.get_property("ior", PropertyType.FLOAT) == pytest.approx(1.5)
    assert len(s.sphere_buffer) == 2
    assert len(s.plane_buffer) == 0


def test_duplicate_material_error():
    text = """Begin Material
Material A
Material A
End
"""
    with pytest.raises(ScnParseError, match="Duplicated"):
        parse_scn(text)


def test_unknown_material_reference_error():
    text = """Begin Material
Material A
End
Begin Model
Model M
Sphere S NoSuchMaterial
End
"""
    with pytest.raises(ScnParseError, match="Invalid material name"):
        parse_scn(text)


def test_syntax_error_and_rollback():
    dst = Scene()
    good = """Begin Material
Material A
End
"""
    parse_scn(good, dst)
    assert len(dst.materials) == 1
    bad = """Begin Material
Material B
End
Begin Model
Model M
Gibberish x y z
End
"""
    with pytest.raises(ScnParseError):
        parse_scn(bad, dst)
    # rollback: nothing from the failed import leaked in
    assert len(dst.materials) == 1
    assert dst.materials[0].name == "A"


def test_merge_offsets():
    dst = Scene()
    a = """Begin Material
Material A
Prop diffuseColor RGB 1 0 0
End
Begin Model
Model M1
Sphere S1 A
R 5
End
"""
    b = """Begin Material
Material B
Prop diffuseColor RGB 0 1 0
End
Begin Model
Model M2
Sphere S2 B
R 7
End
"""
    parse_scn(a, dst)
    parse_scn(b, dst)
    assert len(dst.materials) == 2
    assert len(dst.sphere_buffer) == 2
    # second sphere's material must be remapped to global index 1
    assert dst.sphere_buffer[1].material == 1
    assert dst.nodes[1].entity == 1
    assert dst.models[1].nodes == [1]


def test_comment_and_blank_handling():
    text = """
# top comment
Begin Material
# inner comment
Material A 2

Prop ior Float 1.33
End
"""
    s = parse_scn(text)
    assert s.materials[0].type == 2
    assert s.materials[0].get_property("ior") == pytest.approx(1.33)


def test_cpp_stream_numeric_semantics():
    # trailing-comma token: longest-prefix parse, then next extraction fails ->
    # remaining components become 0 (C++11 failed-extraction value)
    text = """Begin Material
Material X
Prop diffuseColor RGB 0.63 0.065, 0.05
Prop other RGB 1 2 3
End
"""
    s = parse_scn(text)
    assert s.materials[0].get_property("diffuseColor") == \
        pytest.approx((0.63, 0.065, 0.0))
    assert s.materials[0].get_property("other") == pytest.approx((1.0, 2.0, 3.0))


def test_field_before_entity_is_clean_parse_error():
    # a field line before its entity must raise ScnParseError (not a bare
    # IndexError escaping the CLI's handler) — ADVICE r1
    from nrenderer_tpu.io.scn import ScnParseError
    for text in (
        "Begin Model\nR 200\nEnd\n",
        "Begin Model\nModel m\nV1 0 0 0\nEnd\n",
        "Begin Light\nU 1 0 0\nEnd\n",
        "Begin Light\nPoint p\nU 1 0 0\nEnd\n",  # U needs an Area light
    ):
        with pytest.raises(ScnParseError):
            parse_scn(text)
