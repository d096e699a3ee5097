"""BVH build + stackless traversal tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from nrenderer_tpu import build_scene_arrays, load_obj
from nrenderer_tpu.ops.bvh import (
    build_bvh, build_mesh_engine, build_triangle_bvh, intersect_triangles_bvh,
    pack_triangles,
)
from nrenderer_tpu.ops.intersect import (
    intersect_scene_unrolled, make_static_scene,
)
from nrenderer_tpu.ops.soa import V3


@pytest.fixture(scope="module")
def bunny(resource_dir):
    s = load_obj(str(resource_dir / "obj" / "bunny_200_faces.obj"))
    s.models[0].scale = (600.0, 600.0, 600.0)
    s.models[0].translation = (40.0, -305.0, 920.0)
    s.mesh_buffer[0].material = 0
    from nrenderer_tpu.scene.model import Material
    s.materials.append(Material(name="White"))
    return build_scene_arrays(s)


def test_flat_bvh_structure(bunny):
    bvh = build_triangle_bvh(bunny)
    skip = np.asarray(bvh.skip)
    prim = np.asarray(bvh.prim)
    n = bvh.n_nodes
    assert n == 2 * 200 - 1  # 1-prim leaves, binary tree
    # every leaf holds a valid prim exactly once
    leaves = prim[prim >= 0]
    assert len(leaves) == 200
    assert len(set(leaves.tolist())) == 200
    # escape indices advance monotonically past each subtree
    assert (skip > np.arange(n)).all()
    assert (skip <= n).all()


def test_bvh_bounds_contain_children():
    rng = np.random.default_rng(0)
    mn = rng.uniform(-10, 10, (33, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 2.0, (33, 3)).astype(np.float32)
    bmn, bmx, skip, prim = build_bvh(mn, mx)
    # root bbox contains everything
    np.testing.assert_array_less(bmn[0] - 1e-5, mn.min(axis=0))
    np.testing.assert_array_less(mx.max(axis=0), bmx[0] + 1e-5)


def test_traversal_matches_brute_force(bunny):
    ss = make_static_scene(bunny)
    bvh = build_triangle_bvh(bunny)
    tp = pack_triangles(bunny, [(1.0,)])

    rng = np.random.default_rng(7)
    n = 256
    # rays aimed at the bunny's bounding region from random origins
    origins = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
    origins[:, 2] -= 400.0
    targets = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    targets += np.array([40.0, -200.0, 920.0], np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = V3(*(jnp.asarray(origins[:, i]) for i in range(3)))
    dv = V3(*(jnp.asarray(d[:, i]) for i in range(3)))

    brute = intersect_scene_unrolled(ss, o, dv, mat_channels=[(1.0,)])
    t_bvh, nx, ny, nz, mat, pid, chans = intersect_triangles_bvh(bvh, tp, o,
                                                                 dv)
    tb = np.asarray(brute.t)
    tv = np.asarray(t_bvh)
    hit_b = np.isfinite(tb)
    hit_v = np.isfinite(tv)
    assert hit_b.sum() > 20  # the rays do hit the bunny
    np.testing.assert_array_equal(hit_b, hit_v)
    np.testing.assert_allclose(tb[hit_b], tv[hit_v], rtol=1e-4)
    # normals agree too
    np.testing.assert_allclose(np.asarray(brute.normal.x)[hit_b],
                               np.asarray(nx)[hit_v], atol=1e-4)


def _rays_at(targets_center, n, seed, spread=100.0):
    """Component-SoA rays from random origins in front of a target box."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
    origins[:, 2] -= 400.0
    targets = (rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
               + np.asarray(targets_center, np.float32))
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (V3(*(jnp.asarray(origins[:, i]) for i in range(3))),
            V3(*(jnp.asarray(d[:, i]) for i in range(3))))


def _textured_grid(tmp_path, n=6):
    """An n x n-subdivided unit quad at z=0 with UVs 1:1 and a map_Kd."""
    from nrenderer_tpu.io.image import write_png
    write_png(str(tmp_path / "tex.png"), np.full((4, 4, 3), 0.5, np.float32))
    (tmp_path / "g.mtl").write_text("newmtl m\nKd 1 1 1\nmap_Kd tex.png\n")
    lines = ["mtllib g.mtl"]
    lines += [f"v {i / n * 2 - 1} {j / n * 2 - 1} 0"
              for j in range(n + 1) for i in range(n + 1)]
    lines += [f"vt {i / n} {j / n}" for j in range(n + 1) for i in range(n + 1)]
    lines.append("usemtl m")
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i + 1
            b, c, d = a + 1, a + n + 2, a + n + 1
            lines += [f"f {a}/{a} {b}/{b} {c}/{c}", f"f {a}/{a} {c}/{c} {d}/{d}"]
    (tmp_path / "g.obj").write_text("\n".join(lines) + "\n")
    return build_scene_arrays(load_obj(str(tmp_path / "g.obj")))


def test_walk_uv_matches_brute_force(tmp_path):
    """The walk interpolates the winner's texture coords like the unrolled
    intersect does (the renderers' textured-mesh path)."""
    arr = _textured_grid(tmp_path)
    ss = make_static_scene(arr)
    chans = [(1.0,)] * arr.mat_params.shape[0]
    bvh, tp = build_mesh_engine(arr, chans)
    assert tp.tex is not None
    rng = np.random.default_rng(5)
    n = 256
    origins = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                        np.full(n, 3.0)], axis=1).astype(np.float32)
    targets = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                        np.zeros(n)], axis=1).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = V3(*(jnp.asarray(origins[:, i]) for i in range(3)))
    dv = V3(*(jnp.asarray(d[:, i]) for i in range(3)))
    brute = intersect_scene_unrolled(ss, o, dv, mat_channels=chans,
                                     with_uv=True)
    out = intersect_triangles_bvh(bvh, tp, o, dv, with_uv=True)
    t, (u, v, tex) = np.asarray(out[0]), out[7]
    hit = np.isfinite(np.asarray(brute.t))
    assert 50 < hit.sum() < n  # hits and misses both present
    np.testing.assert_array_equal(np.isfinite(t), hit)
    for got, want in zip((u, v, tex), brute.uv):
        np.testing.assert_allclose(np.asarray(got)[hit],
                                   np.asarray(want)[hit], atol=1e-4)
    assert (np.asarray(tex)[~hit] == -1.0).all()


def test_walk_uv_on_untextured_pool(bunny):
    """An untextured pool carries no UV tables; with_uv reports no map."""
    bvh, tp = build_mesh_engine(bunny, [(1.0,)])
    assert tp.tex is None and tp.uv1x is None
    o, dv = _rays_at((40.0, -200.0, 920.0), 64, seed=2)
    out = intersect_triangles_bvh(bvh, tp, o, dv, with_uv=True)
    u, v, tex = (np.asarray(a) for a in out[7])
    assert (u == 0).all() and (v == 0).all() and (tex == -1).all()


def test_mesh_engine_in_closest_hit_matches_brute(resource_dir):
    """The Cornell walls (dense) plus a bunny routed through the walk give
    the brute-force closest hit of the whole scene, mesh ids offset past
    the dense primitives with unique_pids."""
    from nrenderer_tpu import load_scn
    from nrenderer_tpu.ops.pt_core import closest_hit, make_mat_channels
    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    load_obj(str(resource_dir / "obj" / "bunny_200_faces.obj"), scene,
             material=0)
    m = scene.models[-1]
    m.scale = (600.0,) * 3
    m.translation = (40.0, -305.0, 920.0)
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    mat_ch = make_mat_channels(ss)
    o, dv = _rays_at((40.0, -200.0, 920.0), 256, seed=9, spread=200.0)
    brute = closest_hit(ss, o, dv, 1e-3, mat_ch)
    walk = closest_hit(ss, o, dv, 1e-3, mat_ch,
                       tri_bvh=build_mesh_engine(arr, mat_ch),
                       unique_pids=True)
    tb, tw = np.asarray(brute.t), np.asarray(walk.t)
    np.testing.assert_array_equal(np.isfinite(tb), np.isfinite(tw))
    hit = np.isfinite(tb)
    np.testing.assert_allclose(tw[hit], tb[hit], rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(walk.mat_id)[hit],
                                  np.asarray(brute.mat_id)[hit])
    n_dense = len(ss.sph) + len(ss.pln)
    mesh_hit = hit & (np.asarray(walk.prim_id) >= n_dense)
    assert mesh_hit.sum() > 10  # some rays do reach the bunny


@pytest.mark.slow
def test_acc_pt_renders_bunny_with_bvh(resource_dir):
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu import load_scn
    from nrenderer_tpu.server.manager import ComponentManager

    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    load_obj(str(resource_dir / "obj" / "bunny_200_faces.obj"), scene,
             material=0)
    m = scene.models[-1]
    m.scale = (600.0, 600.0, 600.0)
    m.translation = (40.0, -305.0, 920.0)
    scene.render_option.width = 32
    scene.render_option.height = 32
    scene.render_option.samples_per_pixel = 8
    scene.render_option.depth = 4
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", scene)
    img = mgr.wait(timeout=900).pixels
    assert np.isfinite(img).all()
    assert img[..., :3].max() > 0.05
