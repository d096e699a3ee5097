"""MetropolisLightTransport tests (CPU, small chain configs)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nrenderer_tpu
from nrenderer_tpu.resources import RESOURCE_DIR
from nrenderer_tpu import load_scn
from nrenderer_tpu.renderers import mlt as mlt_mod
from nrenderer_tpu.renderers.mlt import render_mlt, vec_cosine
from nrenderer_tpu.ops.soa import V3

nrenderer_tpu._register_builtin_renderers()


@pytest.fixture(scope="module")
def mlt_image(resource_dir):
    scene = load_scn(str(resource_dir / "Metropolis.scn"))
    scene.render_option.width = 48
    scene.render_option.height = 48
    scene.render_option.depth = 6
    return render_mlt(scene, chains=256, mutations=60, n_init=2048, seed=0)


@pytest.mark.slow
def test_shape_and_range(mlt_image):
    assert mlt_image.shape == (48, 48, 4)
    assert np.isfinite(mlt_image).all()
    assert 0.0 <= mlt_image.min() and mlt_image.max() <= 1.0


@pytest.mark.slow
def test_scene_structure(mlt_image):
    img = mlt_image[..., :3]
    assert img.max() > 0.3  # something bright
    # left wall red-dominant, right wall green-dominant
    left = img[18:30, 1:5].mean(axis=(0, 1))
    right = img[18:30, 43:47].mean(axis=(0, 1))
    assert left[0] > left[2]
    assert right[1] > right[0]
    # the glowing light quad near the top center is the brightest area
    light_region = img[2:8, 18:30].sum(axis=2).max()
    assert light_region > img.sum(axis=2).mean()


def test_perturb_stays_in_unit_interval():
    kern = _tiny_kernel()
    u = jnp.linspace(0.01, 0.99, 92 * 8).reshape(92, 8)
    out = kern.mutate(u, jax.random.PRNGKey(1))
    o = np.asarray(out)
    assert (o >= 0.0).all() and (o <= 1.0).all()
    # perturbation is small-scale most of the time
    assert np.median(np.abs(o - np.asarray(u))) < 0.2


def _tiny_kernel():
    from nrenderer_tpu import build_scene_arrays
    from nrenderer_tpu.renderers.mlt import MLTKernel, _mlt_camera
    from nrenderer_tpu.ops.intersect import make_static_scene
    from nrenderer_tpu.scene.model import Scene

    scene = load_scn(str(
        RESOURCE_DIR
        / "Metropolis.scn"))
    arr = build_scene_arrays(scene)
    ss = make_static_scene(arr)
    cam = _mlt_camera(scene.camera, 64, 64)
    return MLTKernel(ss, cam, 64, 64, 20, (95.0, 77.0, 62.0),
                     (0, 0, 0), (1, 0, 0), (0, 0, 1), 1.0)


def test_vec_cosine_distribution():
    """g=1 must be cosine-weighted about n; g=999 nearly parallel to n."""
    n = V3(jnp.zeros(4096), jnp.ones(4096), jnp.zeros(4096))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    r1 = jax.random.uniform(k1, (4096,))
    r2 = jax.random.uniform(k2, (4096,))
    d1 = vec_cosine(n, 1.0, r1, r2)
    cos1 = np.asarray(d1.y)
    assert abs(cos1.mean() - 2.0 / 3.0) < 0.02  # E[cos] = 2/3 for cos-weighted
    d999 = vec_cosine(n, 999.0, r1, r2)
    assert np.asarray(d999.y).min() > 0.98  # the area-laser lobe


def test_no_area_light_is_black(resource_dir):
    scene = load_scn(str(resource_dir / "env_map_spheres.scn"))
    scene.render_option.width = 8
    scene.render_option.height = 8
    img = render_mlt(scene, chains=8, mutations=2, n_init=8)
    assert img[..., :3].max() == 0.0


@pytest.mark.slow
def test_registered_and_runs_via_manager(resource_dir):
    from nrenderer_tpu.server.manager import ComponentManager
    scene = load_scn(str(resource_dir / "Metropolis.scn"))
    scene.render_option.width = 16
    scene.render_option.height = 16
    scene.render_option.depth = 4
    mgr = ComponentManager()
    mgr.exec("ignored", scene,
             component=mlt_mod.MetropolisRenderer(chains=32, mutations=8))
    result = mgr.wait(timeout=600)
    assert result.pixels.shape == (16, 16, 4)


@pytest.mark.slow
def test_resolution_shares_compile(resource_dir):
    """two resolutions in the same film bucket reuse ONE
    cached (b-estimate, init, block) pipeline — w/h are traced args, the
    cache key carries only the bucket."""
    from nrenderer_tpu.renderers.mlt import _MLT_FN_CACHE, render_mlt

    def scene_at(w, h):
        s = load_scn(str(resource_dir / "Metropolis.scn"))
        s.render_option.width = w
        s.render_option.height = h
        s.render_option.depth = 4
        return s

    _MLT_FN_CACHE.clear()
    a = render_mlt(scene_at(24, 24), chains=8, mutations=8, n_init=32,
                   seed=0)
    assert len(_MLT_FN_CACHE) == 1
    # 30x20 = 600 pixels, same 1024-bucket as 24x24 = 576
    b = render_mlt(scene_at(30, 20), chains=8, mutations=8, n_init=32,
                   seed=0)
    assert len(_MLT_FN_CACHE) == 1  # no second compile pipeline
    assert a.shape == (24, 24, 4) and b.shape == (20, 30, 4)
    assert np.isfinite(a).all() and np.isfinite(b).all()


def test_mlt_checkpoint_resume_exact(resource_dir, tmp_path, monkeypatch):
    """MLT disk checkpoint (round 3): interrupting after the first of two
    mutation blocks and resuming yields the EXACT image of a straight run
    (block i re-keys with fold_in(k_loop, i) either way; the snapshot
    carries the full chain state + brightness estimate)."""
    import nrenderer_tpu.renderers.mlt as mlt_mod

    monkeypatch.setenv("NR_MLT_BLOCK", "4")  # mutations=8 -> 2 blocks

    def scene():
        s = load_scn(str(resource_dir / "Metropolis.scn"))
        s.render_option.width = 12
        s.render_option.height = 12
        s.render_option.depth = 4
        return s

    kw = dict(chains=16, mutations=8, n_init=64, seed=3)
    straight = mlt_mod.render_mlt(scene(), **kw)

    ck = str(tmp_path / "mlt.npz")
    real_save = mlt_mod._save_mlt_checkpoint
    calls = {"n": 0}

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(mlt_mod, "_save_mlt_checkpoint", dying_save)
    with pytest.raises(KeyboardInterrupt):
        mlt_mod.render_mlt(scene(), checkpoint_path=ck, **kw)
    monkeypatch.setattr(mlt_mod, "_save_mlt_checkpoint", real_save)
    assert int(np.load(ck)["blocks_done"]) == 1

    resumed = mlt_mod.render_mlt(scene(), checkpoint_path=ck, **kw)
    np.testing.assert_allclose(resumed, straight, rtol=1e-5, atol=1e-6)
    # full resume: a third run loads blocks_done == n_blocks and does no work
    again = mlt_mod.render_mlt(scene(), checkpoint_path=ck, **kw)
    np.testing.assert_allclose(again, straight, rtol=1e-5, atol=1e-6)

    # changing the seed must invalidate the snapshot, not blend into it
    other = mlt_mod.render_mlt(scene(), chains=16, mutations=8, n_init=64,
                               seed=4, checkpoint_path=ck)
    fresh = mlt_mod.render_mlt(scene(), chains=16, mutations=8, n_init=64,
                               seed=4)
    np.testing.assert_allclose(other, fresh, rtol=1e-5, atol=1e-6)


def test_progressive_preview_posts_to_screen(resource_dir, monkeypatch):
    """`--serve` composition: the block loop posts a
    tone-mapped partial film to the Screen after each mutation block, so
    a served MLT render shows progress instead of nothing-until-the-end
    (reference blit loop: ScreenView.cpp:168-178)."""
    from nrenderer_tpu.server.registry import get_server
    monkeypatch.setenv("NR_MLT_BLOCK", "4")   # mutations=12 -> 3 blocks
    monkeypatch.setenv("NR_MLT_PREVIEW_BLOCKS", "1")
    # config matches test_mlt_checkpoint_resume_exact so the in-process
    # _MLT_FN_CACHE entry (and the jit caches) are shared, not recompiled
    scene = load_scn(str(resource_dir / "Metropolis.scn"))
    scene.render_option.width = scene.render_option.height = 12
    scene.render_option.depth = 4
    screen = get_server().screen
    posts = []
    orig = screen.set

    def spy(pixels, w, h):
        posts.append((np.asarray(pixels).copy(), w, h))
        return orig(pixels, w, h)

    monkeypatch.setattr(screen, "set", spy)
    img = render_mlt(scene, chains=16, mutations=12, n_init=64, seed=0)
    # >= 2 mid-render posts (3 blocks, the last is the final flush which
    # returns rather than posts)
    assert len(posts) >= 2
    for p, w, h in posts:
        assert (w, h) == (12, 12) and p.shape == (12, 12, 4)
        assert np.isfinite(p).all() and p.min() >= 0.0 and p.max() <= 1.0
    # previews brighten-normalize by mutations so far: the first partial
    # is a valid image, not a near-black under-scaled film
    assert posts[0][0][..., :3].max() > 0.01


def test_preview_disabled_by_env(resource_dir, monkeypatch):
    from nrenderer_tpu.server.registry import get_server
    monkeypatch.setenv("NR_MLT_BLOCK", "4")
    monkeypatch.setenv("NR_MLT_PREVIEW_BLOCKS", "0")
    scene = load_scn(str(resource_dir / "Metropolis.scn"))
    scene.render_option.width = scene.render_option.height = 12
    scene.render_option.depth = 4
    screen = get_server().screen
    posts = []
    orig = screen.set
    monkeypatch.setattr(screen, "set",
                        lambda px, w, h: (posts.append(1), orig(px, w, h)))
    render_mlt(scene, chains=16, mutations=12, n_init=64, seed=0)
    assert posts == []
