"""SceneBuilder validation + material template tests."""
import pytest

from nrenderer_tpu import Scene, parse_scn
from nrenderer_tpu.scene.builder import (
    SceneBuildError, build_scene, validate_scene,
)
from nrenderer_tpu.scene.templates import make_material, template_names


GOOD = """Begin Material
Material A
Prop diffuseColor RGB 1 0 0
End
Begin Model
Model M
Sphere S A
R 5
End
"""


def test_valid_scene_passes():
    s = parse_scn(GOOD)
    assert validate_scene(s) == []
    snap = build_scene(s)
    assert snap is not s
    assert len(snap.sphere_buffer) == 1


def test_missing_material_raises():
    s = parse_scn(GOOD)
    s.sphere_buffer[0].material = -1
    with pytest.raises(SceneBuildError, match="no material"):
        build_scene(s)


def test_out_of_range_material():
    s = parse_scn(GOOD)
    s.sphere_buffer[0].material = 99
    problems = validate_scene(s)
    assert len(problems) == 1 and "out of range" in problems[0]


def test_snapshot_is_deep():
    s = parse_scn(GOOD)
    snap = build_scene(s)
    s.sphere_buffer[0].radius = 999.0
    assert snap.sphere_buffer[0].radius == pytest.approx(5.0)


def test_templates():
    assert set(template_names()) == {"Lambertian", "Phong", "Dielectric",
                                     "Conductor", "Plastic"}
    m = make_material("Dielectric", "Glass2")
    assert m.type == 2
    assert m.get_property("ior") == pytest.approx(1.5)
    # dedup semantics preserved
    from nrenderer_tpu import Property, PropertyType
    assert not m.register_property(Property("ior", PropertyType.FLOAT, 2.0))


def test_global_microfacet_knob_overrides():
    """RenderOption.roughness/f0/metalness (the reference's global
    RenderSettings knobs, dead in its shipped shaders) override the
    per-material microfacet parameters when SET; None (default) keeps
    per-material values."""
    from nrenderer_tpu import build_scene_arrays
    from nrenderer_tpu.scene.arrays import (
        MAT_F0, MAT_METALNESS, MAT_ROUGHNESS,
    )
    from nrenderer_tpu.scene.model import Property, PropertyType
    import numpy as np

    s = parse_scn(GOOD)
    s.materials[0].register_property(
        Property("roughness", PropertyType.FLOAT, 0.7))

    mp = np.asarray(build_scene_arrays(s).mat_params)
    assert mp[0, MAT_ROUGHNESS] == pytest.approx(0.7)   # per-material
    assert mp[0, MAT_F0] == pytest.approx(0.04)          # reference const
    assert mp[0, MAT_METALNESS] == pytest.approx(0.2)    # Microfacet.cpp:11

    s.render_option.roughness = 0.33
    s.render_option.f0 = 0.08
    s.render_option.metalness = 0.9
    mp = np.asarray(build_scene_arrays(s).mat_params)
    assert (mp[:, MAT_ROUGHNESS] == pytest.approx(0.33))
    assert (mp[:, MAT_F0] == pytest.approx(0.08))
    assert (mp[:, MAT_METALNESS] == pytest.approx(0.9))
