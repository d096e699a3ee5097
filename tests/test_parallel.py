"""Multi-device sharding tests on the 8-virtual-device CPU mesh."""
import numpy as np

# Films are sums over samples and devices, and the banking in the staged
# wavefront and the MLT splat are scatter-adds, which run as atomics on the
# GPU in an order that varies from run to run.  So equal-seed comparisons
# across sharding or a resume hold to float tolerance, not bit for bit.
FILM_TOL = dict(rtol=1e-5, atol=1e-6)
import pytest

import jax
import jax.numpy as jnp

from nrenderer_tpu import load_scn, build_scene_arrays
from nrenderer_tpu.ops.camera import make_camera
from nrenderer_tpu.ops.intersect import make_static_scene
from nrenderer_tpu.parallel.mesh import (
    build_sharded_render, make_mesh, render_multichip,
)
from nrenderer_tpu.resources import RESOURCE_DIR


@pytest.fixture(scope="module")
def setup(resource_dir):
    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = make_camera(scene.camera)
    return ss, cam


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_runs(setup):
    ss, cam = setup
    mesh = make_mesh(8)
    img = np.asarray(render_multichip(ss, cam, 16, 16, 16, 3, mesh=mesh))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0


@pytest.mark.slow
def test_sharded_matches_single_device_exact(setup):
    """The sharded estimator is a plain psum of per-device linear films, so
    the 8-device render at total spp=64 must equal — per pixel, up to float
    rounding — the combination of eight 1-device renders at spp=8 with the
    same seeds (device i's stream is fold_in(base, seeds[i]) either way).
    this catches any mis-scaled psum; a mean-tolerance test
    does not."""
    ss, cam = setup
    img8 = np.asarray(render_multichip(ss, cam, 24, 24, 64, 4,
                                       mesh=make_mesh(8), seed=0))
    # undo each 1-device run's own gamma + spp normalization to recover its
    # linear film sum, combine, and re-apply the 8-device normalization
    film = np.zeros((24, 24, 3), np.float64)
    for i in range(8):
        img1 = np.asarray(render_multichip(ss, cam, 24, 24, 8, 4,
                                           mesh=make_mesh(1), seed=i))
        film += img1.astype(np.float64) ** 2 * 8.0
    expect = np.sqrt(film / 64.0)
    np.testing.assert_allclose(img8, expect, rtol=1e-5, atol=1e-6)


def test_pixel_sharded_matches_single_device_exact(setup):
    """Pixel-axis sharding: each device renders a disjoint
    horizontal band with NO collective — band k of the 8-device render must
    equal a single-device render of the same band with the same seed, to
    FILM_TOL (the reference's row-interleave analogue,
    SimplePathTracer.cpp:80-87)."""
    import jax.numpy as jnp
    from nrenderer_tpu.ops.sampling import make_base_key
    from nrenderer_tpu.parallel.mesh import (
        _linear_film, build_sharded_render_pixels)
    from nrenderer_tpu.renderers.simple_pt import trace_diffuse_wavefront

    ss, cam = setup
    w, h, spp, depth = 16, 32, 4, 3
    mesh = make_mesh(8)
    fn = build_sharded_render_pixels(ss, w, h, spp, depth, mesh)
    seeds = jnp.arange(8, dtype=jnp.int32)
    img8 = np.asarray(fn(cam, seeds))
    assert img8.shape == (h, w, 3)
    assert np.isfinite(img8).all()
    assert img8.max() > 0

    h_loc = h // 8
    trace = lambda o, d, key: trace_diffuse_wavefront(ss, o, d, key, depth)
    for k in range(8):
        key = jax.random.fold_in(make_base_key(0), seeds[k])
        band = _linear_film(trace, cam, w, h, spp, 1, key,
                            row0=float(k * h_loc), rows=h_loc)
        band = np.sqrt(np.maximum(np.asarray(band) / spp, 0.0))
        band = band.reshape(h_loc, w, 3)
        np.testing.assert_allclose(
            img8[k * h_loc:(k + 1) * h_loc], band, **FILM_TOL,
            err_msg=f"band {k} differs from single-device render")


def test_mesh_sizes(setup):
    ss, cam = setup
    for n in (1, 2, 4):
        img = np.asarray(render_multichip(ss, cam, 8, 8, n * 2, 2,
                                          mesh=make_mesh(n)))
        assert np.isfinite(img).all()


def test_spp_divisibility_checked(setup):
    ss, cam = setup
    mesh = make_mesh(8)
    with pytest.raises(AssertionError):
        build_sharded_render(ss, 8, 8, 12, 2, mesh)  # 12 % 8 != 0


def test_sharded_acc_bsdf(setup):
    """Sample-sharded AccPathTracer (4-BSDF wavefront) over 8 devices."""
    from nrenderer_tpu.parallel.mesh import render_multichip_acc

    scene = load_scn(str(RESOURCE_DIR / "pt_glass.scn"))
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = make_camera(scene.camera)
    img8 = np.asarray(render_multichip_acc(ss, cam, 16, 16, 16, 3,
                                           mesh=make_mesh(8), seed=0))
    assert img8.shape == (16, 16, 3)
    assert np.isfinite(img8).all()
    assert img8.max() > 0
    img1 = np.asarray(render_multichip_acc(ss, cam, 16, 16, 16, 3,
                                           mesh=make_mesh(1), seed=9))
    assert abs(img8.mean() - img1.mean()) < 0.08


@pytest.mark.slow
def test_sharded_acc_mesh_engine():
    """Sharded AccPT with the mesh engine replicated across the 8-device
    mesh — the read-only acceleration structure is a baked constant on
    every device."""
    from nrenderer_tpu import load_obj
    from nrenderer_tpu.ops.bvh import build_mesh_engine
    from nrenderer_tpu.ops.pt_core import make_mat_channels
    from nrenderer_tpu.parallel.mesh import render_multichip_acc
    from nrenderer_tpu.scene.model import AreaLight, Material, Property, \
        PropertyType

    s = load_obj(str(RESOURCE_DIR / "obj" / "bunny_200_faces.obj"))
    s.models[0].scale = (600.0, 600.0, 600.0)
    s.models[0].translation = (40.0, -305.0, 920.0)
    s.mesh_buffer[0].material = 0
    m = Material(name="W", type=0)
    m.register_property(Property("diffuseColor", PropertyType.RGB,
                                 (0.7, 0.7, 0.7)))
    s.materials.append(m)
    s.area_light_buffer.append(AreaLight(position=(-200.0, 300.0, 700.0),
                                         u=(400.0, 0.0, 0.0),
                                         v=(0.0, 0.0, 400.0),
                                         radiance=(3.0, 3.0, 3.0)))
    s.camera.position = (0.0, 0.0, -500.0)
    arr = build_scene_arrays(s)
    ss = make_static_scene(arr)
    cam = make_camera(s.camera)
    ma = build_mesh_engine(arr, make_mat_channels(ss))
    img = np.asarray(render_multichip_acc(ss, cam, 16, 16, 8, 2,
                                          mesh=make_mesh(8), seed=0,
                                          tri_bvh=ma))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0


@pytest.mark.slow
def test_sharded_mlt_chains():
    """Chain-sharded MLT over the 8-device mesh agrees statistically with
    the single-chip driver at the same total chain budget."""
    from nrenderer_tpu.parallel.mlt import render_mlt_sharded
    from nrenderer_tpu.renderers.mlt import render_mlt

    scene = load_scn(str(RESOURCE_DIR / "Metropolis.scn"))
    scene.render_option.width = 32
    scene.render_option.height = 32
    scene.render_option.depth = 6

    rgba8 = render_mlt_sharded(scene, chains=128, mutations=32, n_init=512,
                               seed=0, mesh=make_mesh(8))
    assert rgba8.shape == (32, 32, 4)
    assert np.isfinite(rgba8).all()
    assert rgba8[..., :3].max() > 0.05

    rgba1 = render_mlt(scene, chains=128, mutations=32, n_init=512, seed=3)
    # same estimator, independent streams: means agree within MC noise
    assert abs(rgba8[..., :3].mean() - rgba1[..., :3].mean()) < 0.12

    # structure (same checks as tests/test_mlt.py, scaled to 32x32; a
    # plain upper/lower-half mean is too noisy at this budget — verified
    # the single-chip renderer shows the same near-flat halves): the light
    # quad near the top center is the brightest area, left wall
    # red-dominant, right wall green-dominant (row 0 = TOP)
    img = rgba8[..., :3]
    assert img[1:6, 12:20].sum(axis=2).max() > img.sum(axis=2).mean()
    left = img[12:20, 0:4].mean(axis=(0, 1))
    right = img[12:20, 28:32].mean(axis=(0, 1))
    assert left[0] > left[2]
    assert right[1] > right[0]


def test_sharded_acc_textured_mesh(tmp_path):
    """Textures ride the MULTICHIP AccPT path (--devices>1 once silently
    dropped them): a red|green textured quad rendered over the
    8-device mesh must show the texture pattern, and match the 1-device
    textured render in expectation."""
    from nrenderer_tpu import load_obj
    from nrenderer_tpu.io.image import write_png
    from nrenderer_tpu.ops.bvh import build_mesh_engine
    from nrenderer_tpu.ops.pt_core import make_mat_channels
    from nrenderer_tpu.parallel.mesh import render_multichip_acc
    from nrenderer_tpu.scene.model import AreaLight

    teximg = np.zeros((32, 128, 3), np.float32)
    teximg[:, :64] = (1.0, 0.1, 0.1)
    teximg[:, 64:] = (0.1, 1.0, 0.1)
    write_png(str(tmp_path / "tex.png"), teximg)
    (tmp_path / "g.mtl").write_text("newmtl m\nKd 1 1 1\nmap_Kd tex.png\n")
    lines = ["mtllib g.mtl",
             "v -1 -1 0", "v 1 -1 0", "v 1 1 0", "v -1 1 0",
             "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
             "usemtl m", "f 1/1 2/2 3/3", "f 1/1 3/3 4/4"]
    (tmp_path / "g.obj").write_text("\n".join(lines) + "\n")

    scene = load_obj(str(tmp_path / "g.obj"))
    scene.materials[0].type = 0
    scene.area_light_buffer.append(AreaLight(
        position=(-2.0, 2.5, 2.0), u=(4.0, 0.0, 0.0),
        v=(0.0, 0.0, 2.0), radiance=(6.0, 6.0, 6.0)))
    scene.camera.position = (0.0, 0.0, 4.0)
    scene.camera.look_at = (0.0, 0.0, 0.0)
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = make_camera(scene.camera)
    # mirror cli._render_multichip's textured-mesh routing
    bt = build_mesh_engine(arr, make_mat_channels(ss))
    img8 = np.asarray(render_multichip_acc(
        ss, cam, 32, 32, 16, 3, mesh=make_mesh(8), seed=0, tri_bvh=bt,
        textures=arr.textures))
    assert np.isfinite(img8).all()
    left, right = img8[8:24, 4:14], img8[8:24, 18:28]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()    # red half
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()  # green half
    img1 = np.asarray(render_multichip_acc(
        ss, cam, 32, 32, 16, 3, mesh=make_mesh(1), seed=9, tri_bvh=bt,
        textures=arr.textures))
    assert abs(img8.mean() - img1.mean()) < 0.08


def test_acc_pixel_sharded_matches_single_device_exact(resource_dir):
    """AccPathTracer pixel-axis sharding (round 3): band k of the 8-device
    4-BSDF render equals a single-device render of the same band with the
    same seed, to FILM_TOL — same contract as the SimplePathTracer
    variant, through the glass/conductor bounce physics."""
    from nrenderer_tpu.ops.sampling import make_base_key
    from nrenderer_tpu.parallel.mesh import (
        _linear_film, build_sharded_render_acc_pixels)
    from nrenderer_tpu.renderers.acc_pt import trace_bsdf_wavefront

    scene = load_scn(str(resource_dir / "pt_glass.scn"))
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = make_camera(scene.camera)
    w, h, spp, depth = 16, 16, 4, 3
    mesh = make_mesh(8)
    fn = build_sharded_render_acc_pixels(ss, w, h, spp, depth, mesh)
    seeds = jnp.arange(8, dtype=jnp.int32)
    img8 = np.asarray(fn(cam, seeds))
    assert img8.shape == (h, w, 3)
    assert np.isfinite(img8).all()
    assert img8.max() > 0

    h_loc = h // 8
    trace = lambda o, d, key: trace_bsdf_wavefront(ss, o, d, key, depth)
    for k in range(8):
        key = jax.random.fold_in(make_base_key(0), seeds[k])
        band = _linear_film(trace, cam, w, h, spp, 1, key,
                            row0=float(k * h_loc), rows=h_loc)
        band = np.sqrt(np.maximum(np.asarray(band) / spp, 0.0))
        band = band.reshape(h_loc, w, 3)
        np.testing.assert_allclose(
            img8[k * h_loc:(k + 1) * h_loc], band, **FILM_TOL,
            err_msg=f"band {k} differs from single-device render")


def test_multichip_resumable_kill_and_resume(setup, tmp_path, monkeypatch):
    """kill a sharded render after its first checkpoint
    snapshot, resume, and the film equals a straight run to FILM_TOL —
    pass p re-keys with the same global step offsets either way."""
    import nrenderer_tpu.parallel.mesh as pm
    import nrenderer_tpu.server.checkpoint as ckpt
    from nrenderer_tpu.renderers.simple_pt import trace_diffuse_wavefront

    ss, cam = setup
    mesh = make_mesh(8)

    def trace(o, d, key):
        return trace_diffuse_wavefront(ss, o, d, key, 3)

    kw = dict(cam=cam, width=16, height=16, spp=32, mesh=mesh, seed=5,
              shard="samples", passes=4)
    straight = pm.render_multichip_resumable(trace, **kw)

    ck = str(tmp_path / "mc.npz")
    real_save = ckpt.save_checkpoint
    calls = {"n": 0}

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", dying_save)
    with pytest.raises(KeyboardInterrupt):
        pm.render_multichip_resumable(trace, checkpoint_path=ck, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", real_save)
    assert int(np.load(ck)["spp_done"]) == 8  # 1 of 4 passes done

    previews = []
    resumed = pm.render_multichip_resumable(
        trace, checkpoint_path=ck, on_preview=lambda s, i: previews.append(s),
        **kw)
    np.testing.assert_allclose(resumed, straight, **FILM_TOL)
    assert previews == [16, 24, 32]  # passes 2-4 re-ran, each previewed

    # a different seed must not resume onto the stale snapshot
    other = pm.render_multichip_resumable(
        trace, checkpoint_path=ck, cam=cam, width=16, height=16, spp=32,
        mesh=mesh, seed=6, shard="samples", passes=4)
    fresh = pm.render_multichip_resumable(
        trace, cam=cam, width=16, height=16, spp=32, mesh=mesh, seed=6,
        shard="samples", passes=4)
    np.testing.assert_allclose(other, fresh, **FILM_TOL)


def test_multichip_resumable_pixel_shard(setup, tmp_path):
    """Pixel-band sharding composes with the resumable driver too: the
    checkpointed run equals the uncheckpointed one."""
    import nrenderer_tpu.parallel.mesh as pm
    from nrenderer_tpu.renderers.simple_pt import trace_diffuse_wavefront

    ss, cam = setup
    mesh = make_mesh(8)

    def trace(o, d, key):
        return trace_diffuse_wavefront(ss, o, d, key, 3)

    kw = dict(cam=cam, width=16, height=16, spp=8, mesh=mesh, seed=1,
              shard="pixels", passes=2)
    a = pm.render_multichip_resumable(trace, **kw)
    b = pm.render_multichip_resumable(
        trace, checkpoint_path=str(tmp_path / "px.npz"), **kw)
    np.testing.assert_allclose(a, b, **FILM_TOL)
    assert a.shape == (16, 16, 3) and np.isfinite(a).all() and a.max() > 0


@pytest.mark.slow
def test_sharded_mlt_checkpoint_resume(resource_dir, tmp_path, monkeypatch):
    """Sharded MLT resumes from a mid-render snapshot to the same film
    (the full device-sharded chain carry round-trips through host numpy
    and is re-sharded by the shard_map in_specs)."""
    import nrenderer_tpu.renderers.mlt as mlt_mod
    from nrenderer_tpu.parallel.mlt import render_mlt_sharded

    monkeypatch.setenv("NR_MLT_BLOCK", "4")  # mutations=8 -> 2 blocks

    def scene():
        s = load_scn(str(resource_dir / "Metropolis.scn"))
        s.render_option.width = 12
        s.render_option.height = 12
        s.render_option.depth = 4
        return s

    mesh = make_mesh(8)
    kw = dict(chains=16, mutations=8, n_init=64, seed=3, mesh=mesh)
    straight = render_mlt_sharded(scene(), **kw)

    ck = str(tmp_path / "mlt_mc.npz")
    real_save = mlt_mod._save_mlt_checkpoint
    calls = {"n": 0}

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(mlt_mod, "_save_mlt_checkpoint", dying_save)
    with pytest.raises(KeyboardInterrupt):
        render_mlt_sharded(scene(), checkpoint_path=ck, **kw)
    monkeypatch.setattr(mlt_mod, "_save_mlt_checkpoint", real_save)
    assert int(np.load(ck)["blocks_done"]) == 1

    resumed = render_mlt_sharded(scene(), checkpoint_path=ck, **kw)
    np.testing.assert_allclose(resumed, straight, rtol=1e-5, atol=1e-6)
