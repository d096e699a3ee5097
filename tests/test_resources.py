"""The committed inputs: stock scenes, generated meshes, the env map, and
the PNG decoder that reads it without Pillow."""
import numpy as np
import pytest

from nrenderer_tpu import load_obj, load_scn
from nrenderer_tpu.io import image
from nrenderer_tpu.resources import (
    BUNNY_FACES, ENV_MAP, RESOURCE_DIR, attach_env_map, blob_mesh,
    bunny_path, env_map_image)

STOCK = ["Metropolis.scn", "conductors.scn", "env_map_spheres.scn",
         "mycornel.scn", "path_tracing_cornel.scn", "pt_glass.scn",
         "ray_cast_cornel.scn"]


@pytest.mark.parametrize("name", STOCK)
def test_stock_scene_lists_its_assumptions(name):
    text = (RESOURCE_DIR / name).read_text()
    assert "# assumed:" in text


@pytest.mark.parametrize("tag", sorted(BUNNY_FACES))
def test_committed_mesh_matches_generator(tag):
    verts, faces = blob_mesh(BUNNY_FACES[tag])
    mesh = load_obj(bunny_path(tag)).mesh_buffer[0]
    got = mesh.positions[mesh.position_indices.reshape(-1, 3)]
    np.testing.assert_allclose(got, verts[faces], atol=2e-6)


@pytest.mark.parametrize("n_faces", sorted(BUNNY_FACES.values()))
def test_blob_mesh_is_closed_and_outward(n_faces):
    verts, faces = blob_mesh(n_faces)
    assert faces.shape == (n_faces, 3)
    # closed 2-manifold: every directed edge appears once, and its reverse
    # once (consistent winding)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    directed = {tuple(e) for e in edges.tolist()}
    assert len(directed) == edges.shape[0]
    assert all((b, a) in directed for a, b in directed)
    # outward winding: positive signed volume
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    assert np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() > 0


def test_env_map_matches_generator():
    img = image.load_image(str(ENV_MAP))
    want = env_map_image().astype(np.float32) / 255.0
    np.testing.assert_array_equal(img[..., :3], want)
    assert (img[..., 3] == 1.0).all()


def test_png_decodes_without_pillow(monkeypatch, tmp_path):
    monkeypatch.setattr(image, "_HAVE_PIL", False)
    img = image.load_image(str(ENV_MAP))
    assert img.shape == (256, 512, 4)
    # every row filter (None/Sub/Up/Average/Paeth) decodes exactly
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    raw = b""
    for y, ftype in enumerate([0, 1, 2, 3, 4, 1]):
        line = px[y].astype(np.int32).reshape(-1)
        prev = px[y - 1].astype(np.int32).reshape(-1) if y else \
            np.zeros_like(line)
        left = np.concatenate([np.zeros(3, np.int32), line[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        elif ftype == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = 0
        raw += bytes([ftype]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes()
    import struct
    import zlib
    png = (b"\x89PNG\r\n\x1a\n"
           + image._png_chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 2,
                                                   0, 0, 0))
           + image._png_chunk(b"IDAT", zlib.compress(raw))
           + image._png_chunk(b"IEND", b""))
    np.testing.assert_array_equal(image.decode_png(png)[..., :3], px)


@pytest.mark.parametrize("content", [None, b"not an image"])
def test_load_image_raises(tmp_path, monkeypatch, content):
    monkeypatch.setattr(image, "_HAVE_PIL", False)
    path = tmp_path / "x.png"
    if content is not None:
        path.write_bytes(content)
    with pytest.raises(image.ImageDecodeError):
        image.load_image(str(path))


def test_attach_env_map_sets_ambient():
    scene = attach_env_map(load_scn(str(RESOURCE_DIR
                                        / "env_map_spheres.scn")))
    assert scene.ambient.type.name == "ENVIRONMENT_MAP"
    tex = scene.textures[scene.ambient.environment_map]
    assert tex.pixels.shape == (256, 512, 4)
