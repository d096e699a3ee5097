"""The repository's input files: stock scenes, meshes and the env map.

Everything a render reads from disk lives under `RESOURCE_DIR`, the
`resources/` directory at the root of the checkout.  The seven `.scn` files
are hand-written.  The meshes and the environment map are generated from a
seed by this module and committed; regenerate them with

    python -m nrenderer_tpu.resources

The stock Stanford-bunny OBJs of the original project are not available, so
`blob_mesh` builds a deterministic closed triangle mesh with the same face
counts (200, 1000 and 4968 faces) and the same bounding box, so that the
bunny placement used across the code base (scale 600, translation
(40, -305, 920)) puts it on the Cornell floor.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

RESOURCE_DIR = pathlib.Path(__file__).resolve().parent.parent / "resources"
ENV_MAP = RESOURCE_DIR / "textures" / "env_sky.png"

# face count of each committed mesh, by its file tag
BUNNY_FACES = {"200": 200, "1k": 1000, "5k": 4968}
# (longitude segments, latitude bands) of the generating sphere grid:
# faces = 2 * n_lon * (n_lat - 1)
_GRID = {200: (10, 11), 1000: (25, 21), 4968: (46, 55)}
# the Stanford bunny's bounding box, which the stock placement assumes
_BBOX_MIN = np.array([-0.0947, 0.0330, -0.0619])
_BBOX_MAX = np.array([0.0610, 0.1873, 0.0588])


def scene_path(name: str) -> str:
    """Path of a stock scene, e.g. `scene_path("pt_glass.scn")`."""
    return str(RESOURCE_DIR / name)


def bunny_path(tag: str) -> str:
    """Path of a stock mesh: tag "200", "1k" or "5k"."""
    return str(RESOURCE_DIR / "obj" / f"bunny_{tag}_faces.obj")


def blob_mesh(n_faces: int, seed: int = 0):
    """Closed, outward-wound triangle mesh of exactly `n_faces` faces.

    A latitude-longitude sphere grid whose radius is modulated by a few
    seeded low-frequency harmonics plus two "ear" bumps, then fitted to the
    bunny's bounding box.  The radius stays positive, so the surface is
    star-shaped around its centre and never intersects itself.  Returns
    (vertices (V, 3) float64, faces (F, 3) int64, 0-based)."""
    n_lon, n_lat = _GRID[n_faces]
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]          # ring polar angles
    phi = np.arange(n_lon) * (2.0 * np.pi / n_lon)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0]], dirs, [[0.0, -1.0, 0.0]]])

    r = np.ones(dirs.shape[0])
    for _ in range(6):
        k = rng.normal(size=3)
        k *= rng.uniform(1.0, 3.0) / np.linalg.norm(k)
        r += rng.uniform(0.03, 0.08) * np.sin(dirs @ k + rng.uniform(0, 6.3))
    for ear in ((0.35, 0.9, 0.25), (0.1, 0.95, 0.3)):
        a = np.asarray(ear) / np.linalg.norm(ear)
        r += 0.45 * np.exp(-(1.0 - dirs @ a) * 40.0)
    verts = dirs * r[:, None]

    faces = []
    ring = lambda i, j: 1 + i * n_lon + (j % n_lon)  # noqa: E731
    south = verts.shape[0] - 1
    for j in range(n_lon):
        faces.append((0, ring(0, j + 1), ring(0, j)))
        faces.append((south, ring(n_lat - 2, j), ring(n_lat - 2, j + 1)))
        for i in range(n_lat - 2):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j + 1), ring(i + 1, j)
            faces.append((a, b, c))
            faces.append((a, c, d))
    faces = np.asarray(faces, np.int64)

    lo, hi = verts.min(axis=0), verts.max(axis=0)
    verts = _BBOX_MIN + (verts - lo) / (hi - lo) * (_BBOX_MAX - _BBOX_MIN)
    return verts, faces


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    lines = ["# generated by nrenderer_tpu.resources.blob_mesh"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def env_map_image(seed: int = 0, height: int = 256,
                  width: int = 512) -> np.ndarray:
    """Equirectangular sky as (H, W, 3) uint8: a horizon gradient, a bright
    sun disc, a darker ground and seeded cloud bands."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height) + 0.5) / height           # 0 = up, 1 = down
    u = (np.arange(width) + 0.5) / width
    vv, uu = np.meshgrid(v, u, indexing="ij")
    elev = (0.5 - vv) * np.pi                         # latitude
    sky = np.stack([0.35 + 0.4 * vv, 0.5 + 0.35 * vv, 0.85 + 0.1 * vv], -1)
    ground = np.stack([0.3 + 0 * vv, 0.26 + 0 * vv, 0.2 + 0 * vv], -1)
    img = np.where((elev > 0)[..., None], sky, ground)
    clouds = np.zeros_like(vv)
    for _ in range(8):
        fu, fv = rng.integers(1, 6), rng.integers(2, 9)
        clouds += rng.uniform(0.2, 1.0) * np.sin(
            2 * np.pi * (fu * uu + rng.uniform()) + fv * elev
            + rng.uniform(0, 6.3))
    clouds = np.clip(clouds / 4.0, 0.0, 1.0) * (elev > 0.05)
    img = img * (1.0 - 0.6 * clouds[..., None]) + 0.6 * clouds[..., None]
    su, sv = rng.uniform(0.1, 0.9), rng.uniform(0.2, 0.35)
    d2 = ((uu - su) * 2.0) ** 2 + (vv - sv) ** 2
    img = img + np.exp(-d2 / 2e-4)[..., None] * np.array([1.0, 0.95, 0.8])
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def attach_env_map(scene, path: str = None):
    """Make `scene`'s ambient the equirectangular map at `path` (default:
    the committed sky).  Raises if the image cannot be decoded."""
    from .io.image import load_image
    from .scene.model import AmbientType, Texture
    path = str(path or ENV_MAP)
    pixels = load_image(path)
    scene.ambient.environment_map = len(scene.textures)
    scene.textures.append(Texture(name=path, pixels=pixels))
    scene.ambient.type = AmbientType.ENVIRONMENT_MAP
    return scene


def write_generated() -> None:
    """(Re)write the committed meshes and env map from their seeds."""
    from .io.image import encode_png_plain
    (RESOURCE_DIR / "obj").mkdir(parents=True, exist_ok=True)
    for tag, n in BUNNY_FACES.items():
        verts, faces = blob_mesh(n)
        pathlib.Path(bunny_path(tag)).write_text(obj_text(verts, faces))
    ENV_MAP.parent.mkdir(parents=True, exist_ok=True)
    ENV_MAP.write_bytes(encode_png_plain(env_map_image()))


if __name__ == "__main__":
    write_generated()
    sys.exit(0)
