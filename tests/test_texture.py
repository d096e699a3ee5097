"""Surface texture sampling (diffuseMap): UV flattening, interpolation,
and a textured-OBJ render.

The reference imports map_Kd and plumbs textures into every shader but no
shade() ever reads them (`Shader.hpp:22`); these tests cover the rebuild's
completed path: OBJ `vt`/`f v/t` -> SceneArrays tri_uv* -> unrolled-hit UV
interpolation -> nearest-neighbor texel in the bounce.
"""
import numpy as np
import pytest

import nrenderer_tpu
from nrenderer_tpu import build_scene_arrays, load_obj
from nrenderer_tpu.ops.intersect import (
    intersect_scene_unrolled, make_static_scene,
)
from nrenderer_tpu.ops.soa import V3

nrenderer_tpu._register_builtin_renderers()


def _texture_png(path, left_rgb=(1.0, 0.0, 0.0), right_rgb=(0.0, 1.0, 0.0),
                 size=8):
    from nrenderer_tpu.io.image import write_png
    img = np.zeros((size, size, 3), np.float32)
    img[:, : size // 2] = left_rgb
    img[:, size // 2:] = right_rgb
    write_png(str(path), img)
    return img


def _textured_quad_obj(tmp_path):
    """Unit quad in the z=0 plane, UV-mapped 1:1, with a left-red /
    right-green map_Kd texture."""
    _texture_png(tmp_path / "tex.png")
    (tmp_path / "quad.mtl").write_text(
        "newmtl quadmat\nKd 1 1 1\nmap_Kd tex.png\n")
    (tmp_path / "quad.obj").write_text(
        "mtllib quad.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl quadmat\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    return load_obj(str(tmp_path / "quad.obj"))


def test_uv_flattening(tmp_path):
    scene = _textured_quad_obj(tmp_path)
    arr = build_scene_arrays(scene)
    tex = np.asarray(arr.tri_tex)
    valid = np.asarray(arr.tri_valid)
    assert (tex[valid] == 0).all()          # both faces carry texture 0
    assert len(arr.textures) == 1
    assert arr.textures[0].shape == (8, 8, 3)
    # face 1 uvs: (0,0) (1,0) (1,1)
    assert np.allclose(np.asarray(arr.tri_uv1)[0], (0, 0))
    assert np.allclose(np.asarray(arr.tri_uve1)[0], (1, 0))
    assert np.allclose(np.asarray(arr.tri_uve2)[0], (1, 1))


def test_unrolled_hit_uv_interpolation(tmp_path):
    scene = _textured_quad_obj(tmp_path)
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    assert len(ss.tri_uv) == 2
    # rays straight down -z at known quad points
    px = np.asarray([-0.5, 0.5, 0.0], np.float32)   # left, right, center
    py = np.asarray([-0.5, -0.5, 0.0], np.float32)
    o = V3(px, py, np.full(3, 5.0, np.float32))
    d = V3(np.zeros(3, np.float32), np.zeros(3, np.float32),
           np.full(3, -1.0, np.float32))
    hit = intersect_scene_unrolled(ss, o, d, with_uv=True)
    assert np.asarray(hit.valid).all()
    tu, tv, tid = (np.asarray(x) for x in hit.uv)
    assert (tid == 0).all()
    # uv = (x+1)/2, (y+1)/2 for this mapping
    assert np.allclose(tu, (px + 1) / 2, atol=1e-5)
    assert np.allclose(tv, (py + 1) / 2, atol=1e-5)


def test_sample_texture_wrap_and_flip():
    from nrenderer_tpu.ops.texture import sample_texture
    tex = np.zeros((4, 4, 3), np.float32)
    tex[0] = (0.9, 0.0, 0.0)   # TOP row of the image = v near 1
    tex[3] = (0.0, 0.9, 0.0)   # bottom row = v near 0
    u = np.asarray([0.1, 0.1, 1.1], np.float32)       # third wraps
    v = np.asarray([0.95, 0.05, 0.95], np.float32)
    out = sample_texture(np.asarray(tex), u, v)
    assert np.allclose(np.asarray(out.x), (0.9, 0.0, 0.9), atol=1e-6)
    assert np.allclose(np.asarray(out.y), (0.0, 0.9, 0.0), atol=1e-6)


def test_textured_obj_render(tmp_path):
    """End-to-end: the textured quad lit head-on renders red-dominant on
    the left and green-dominant on the right."""
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer
    from nrenderer_tpu.scene.model import AreaLight

    scene = _textured_quad_obj(tmp_path)
    scene.area_light_buffer.append(AreaLight(
        position=(-2.0, 2.5, 2.0), u=(4.0, 0.0, 0.0), v=(0.0, 0.0, 2.0),
        radiance=(6.0, 6.0, 6.0)))
    scene.camera.position = (0.0, 0.0, 4.0)
    scene.camera.look_at = (0.0, 0.0, 0.0)
    ro = scene.render_option
    ro.width = ro.height = 32
    ro.samples_per_pixel = 32
    ro.depth = 3
    img = SimplePathTracerRenderer(seed=0).render(scene).pixels[..., :3]
    left = img[8:24, 4:14]
    right = img[8:24, 18:28]
    assert left[..., 0].mean() > 2.0 * left[..., 1].mean()
    assert right[..., 1].mean() > 2.0 * right[..., 0].mean()


def test_mtl_map_ks_bump_parse(tmp_path):
    """map_Kd/map_Ks/map_bump all parse into texture-id properties and
    mat_params columns (reference `ObjImporter.cpp:52-61` loads all three;
    VERDICT r3 #9)."""
    from nrenderer_tpu.scene.arrays import (
        MAT_BUMP_MAP, MAT_DIFFUSE_MAP, MAT_SPECULAR_MAP,
    )
    from nrenderer_tpu.scene.model import PropertyType

    _texture_png(tmp_path / "kd.png")
    _texture_png(tmp_path / "ks.png")
    _texture_png(tmp_path / "bump.png")
    (tmp_path / "m.mtl").write_text(
        "newmtl m\nKd 1 1 1\nmap_Kd kd.png\nmap_Ks ks.png\n"
        "map_bump bump.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\n"
        "usemtl m\n"
        "f 1/1 2/2 3/3\n")
    scene = load_obj(str(tmp_path / "m.obj"))
    mat = scene.materials[0]
    assert mat.get_property("diffuseMap", PropertyType.TEXTURE_ID) == 0
    assert mat.get_property("specularMap", PropertyType.TEXTURE_ID) == 1
    assert mat.get_property("bumpMap", PropertyType.TEXTURE_ID) == 2
    assert len(scene.textures) == 3

    arr = build_scene_arrays(scene)
    mp = np.asarray(arr.mat_params)
    assert mp[0, MAT_DIFFUSE_MAP] == 0
    assert mp[0, MAT_SPECULAR_MAP] == 1
    assert mp[0, MAT_BUMP_MAP] == 2
    valid = np.asarray(arr.tri_valid)
    assert (np.asarray(arr.tri_tex)[valid] == 0).all()
    assert (np.asarray(arr.tri_stex)[valid] == 1).all()


def _spec_mapped_mirror_scene(tmp_path, n=1):
    """An n x n-subdivided quad with a CONDUCTOR material whose specular
    tint comes from a left-red / right-green map_Ks, plus a large area
    light the mirrored camera rays land on."""
    from nrenderer_tpu.scene.model import AreaLight, Property, PropertyType

    _texture_png(tmp_path / "ks.png")
    (tmp_path / "mirror.mtl").write_text(
        "newmtl mirror\nKd 0 0 0\nmap_Ks ks.png\n")
    verts, uvs, faces = [], [], []
    for j in range(n + 1):
        for i in range(n + 1):
            verts.append((i / n * 2 - 1, j / n * 2 - 1, 0.0))
            uvs.append((i / n, j / n))
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i + 1
            b, c_, d_ = a + 1, a + n + 2, a + n + 1
            faces.append((a, b, c_))
            faces.append((a, c_, d_))
    lines = ["mtllib mirror.mtl"]
    lines += [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"vt {u} {v}" for u, v in uvs]
    lines.append("usemtl mirror")
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in faces]
    (tmp_path / "mirror.obj").write_text("\n".join(lines) + "\n")

    scene = load_obj(str(tmp_path / "mirror.obj"))
    mat = scene.materials[0]
    mat.type = 1  # conductor (acc ShaderCreator mapping)
    mat.register_property(Property("eta_r", PropertyType.VEC3,
                                   (0.2, 0.2, 0.2)))
    mat.register_property(Property("eta_i", PropertyType.VEC3,
                                   (3.0, 3.0, 3.0)))
    mat.register_property(Property("albedo", PropertyType.RGB,
                                   (1.0, 1.0, 1.0)))
    # big light plane at z=+5: every camera ray mirrored off the quad
    # (normal +z) lands on it
    scene.area_light_buffer.append(AreaLight(
        position=(-10.0, -10.0, 5.0), u=(20.0, 0.0, 0.0),
        v=(0.0, 20.0, 0.0), radiance=(4.0, 4.0, 4.0)))
    scene.camera.position = (0.0, 0.0, 4.0)
    scene.camera.look_at = (0.0, 0.0, 0.0)
    ro = scene.render_option
    ro.width = ro.height = 32
    ro.samples_per_pixel = 16
    ro.depth = 3
    return scene


def test_specular_map_unrolled_path(tmp_path):
    """map_Ks modulates the conductor lobe through the unrolled (small
    scene) engine: the mirror quad reflects the light tinted left-red /
    right-green."""
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer

    scene = _spec_mapped_mirror_scene(tmp_path, n=1)
    img = AccPathTracerRenderer(seed=0).render(scene).pixels[..., :3]
    left = img[8:24, 4:14]
    right = img[8:24, 18:28]
    assert left[..., 0].mean() > 2.0 * left[..., 1].mean()
    assert right[..., 1].mean() > 2.0 * right[..., 0].mean()


@pytest.mark.slow
def test_specular_map_mesh_grid(tmp_path):
    """A textured grid with a specular map: the 128-face grid takes the
    BVH mesh walk (>BVH_THRESHOLD) and map_Ks still
    reaches the conductor lobe (spec-tex id rides the material channels,
    UVs the per-face tables)."""
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer

    scene = _spec_mapped_mirror_scene(tmp_path, n=8)
    img = AccPathTracerRenderer(seed=0).render(scene).pixels[..., :3]
    left = img[8:24, 4:14]
    right = img[8:24, 18:28]
    assert left[..., 0].mean() > 2.0 * left[..., 1].mean()
    assert right[..., 1].mean() > 2.0 * right[..., 0].mean()


@pytest.mark.slow
def test_textured_mesh_bvh_path(tmp_path):
    """Textures survive the BVH mesh walk (>BVH_THRESHOLD tris):
    an 8x8-subdivided quad (128 faces) renders left-red / right-green
    through AccPathTracer's BVH path."""
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer
    from nrenderer_tpu.scene.model import AreaLight

    _texture_png(tmp_path / "tex.png")
    (tmp_path / "grid.mtl").write_text(
        "newmtl gridmat\nKd 1 1 1\nmap_Kd tex.png\n")
    n = 8
    verts, uvs, faces = [], [], []
    for j in range(n + 1):
        for i in range(n + 1):
            verts.append((i / n * 2 - 1, j / n * 2 - 1, 0.0))
            uvs.append((i / n, j / n))
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i + 1      # OBJ 1-based
            b, c_, d_ = a + 1, a + n + 2, a + n + 1
            faces.append((a, b, c_))
            faces.append((a, c_, d_))
    lines = ["mtllib grid.mtl"]
    lines += [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"vt {u} {v}" for u, v in uvs]
    lines.append("usemtl gridmat")
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in faces]
    (tmp_path / "grid.obj").write_text("\n".join(lines) + "\n")

    scene = load_obj(str(tmp_path / "grid.obj"))
    scene.materials[0].type = 0  # Lambertian (MTL imports as Phong)
    scene.area_light_buffer.append(AreaLight(
        position=(-2.0, 2.5, 2.0), u=(4.0, 0.0, 0.0), v=(0.0, 0.0, 2.0),
        radiance=(6.0, 6.0, 6.0)))
    scene.camera.position = (0.0, 0.0, 4.0)
    scene.camera.look_at = (0.0, 0.0, 0.0)
    ro = scene.render_option
    ro.width = ro.height = 32
    ro.samples_per_pixel = 32
    ro.depth = 3
    img = AccPathTracerRenderer(seed=0).render(scene).pixels[..., :3]
    left = img[8:24, 4:14]
    right = img[8:24, 18:28]
    assert left[..., 0].mean() > 2.0 * left[..., 1].mean()
    assert right[..., 1].mean() > 2.0 * right[..., 0].mean()
