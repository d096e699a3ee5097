"""Staged (compacting) wavefront: unbiasedness vs the plain wavefront.

The staged wavefront (`renderers/_wavefront.build_staged_wavefront_fn`)
packs the whole ray state into smaller buffers at scheduled bounce
boundaries, resolving overflow by russian roulette with 1/q reweighting.
These tests drive it through the real renderer wiring (NR_STAGED=1) and
check the estimator against the plain wavefront within MC noise.

A closed Cornell box at depth 13 keeps the alive fraction far above the
1/2 and 1/4 stage capacities, so the RR overflow path (not just the
happy packing path) is what's being validated.
"""
import numpy as np

import nrenderer_tpu
from nrenderer_tpu import load_scn
from nrenderer_tpu.server.manager import ComponentManager

nrenderer_tpu._register_builtin_renderers()


def render(resource_dir, w=48, h=48, spp=64, depth=13):
    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    scene.render_option.width = w
    scene.render_option.height = h
    scene.render_option.samples_per_pixel = spp
    scene.render_option.depth = depth
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", scene)
    return mgr.wait(timeout=600).pixels[..., :3]


def test_staged_matches_plain_wavefront(resource_dir, monkeypatch):
    monkeypatch.delenv("NR_STAGED", raising=False)
    plain = render(resource_dir)
    monkeypatch.setenv("NR_STAGED", "1")
    staged = render(resource_dir)
    assert np.isfinite(staged).all()
    assert (staged >= 0).all()
    # same estimator, different sample sequence (packing re-slots the RNG
    # lanes) -> agree in expectation; RR reweighting adds variance, so the
    # bound is on the image MEAN, not per-pixel
    assert abs(staged.mean() - plain.mean()) < 0.02
    # and per-pixel agreement at MC-noise scale (sqrt(64) averaging)
    assert np.abs(staged - plain).mean() < 0.06


def test_staged_stage_plan_boundaries():
    from nrenderer_tpu.renderers._wavefront import stage_plan
    # absolute bounce boundaries, clipped to depth
    assert stage_plan(20) == [(0, 1), (6, 2), (11, 4), (16, 8)]
    assert stage_plan(8) == [(0, 1), (6, 2)]
    assert stage_plan(5) == [(0, 1)]


def test_staged_env_map_matches_plain(resource_dir, monkeypatch):
    """The staged bounce's env-miss branch (with_miss + env add) agrees
    with the plain wavefront on an environment-lit scene."""
    import numpy as np
    from nrenderer_tpu.scene.model import AmbientType, Texture

    def setup():
        scene = load_scn(str(resource_dir / "env_map_spheres.scn"))
        px = np.zeros((8, 16, 3), np.float32)
        px[:4] = (0.2, 0.4, 1.0)   # sky
        px[4:] = (0.3, 0.25, 0.2)  # ground
        scene.ambient.environment_map = len(scene.textures)
        scene.textures.append(Texture(name="env", pixels=px))
        scene.ambient.type = AmbientType.ENVIRONMENT_MAP
        ro = scene.render_option
        ro.width = ro.height = 32
        ro.samples_per_pixel = 32
        ro.depth = 7  # crosses the first stage boundary (6)
        return scene

    monkeypatch.delenv("NR_STAGED", raising=False)
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", setup())
    plain = mgr.wait(timeout=600).pixels[..., :3]
    monkeypatch.setenv("NR_STAGED", "1")
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", setup())
    staged = mgr.wait(timeout=600).pixels[..., :3]
    assert np.isfinite(staged).all()
    assert staged.max() > 0.05  # env light reaches the film
    assert abs(staged.mean() - plain.mean()) < 0.03


def test_staged_thin_lens_matches_plain(resource_dir, monkeypatch):
    """Staged camera stage draws the same thin-lens distribution."""
    import numpy as np

    def setup():
        scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
        scene.camera.aperture = 20.0
        ro = scene.render_option
        ro.width = ro.height = 32
        ro.samples_per_pixel = 32
        ro.depth = 7
        return scene

    monkeypatch.delenv("NR_STAGED", raising=False)
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", setup())
    plain = mgr.wait(timeout=600).pixels[..., :3]
    monkeypatch.setenv("NR_STAGED", "1")
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", setup())
    staged = mgr.wait(timeout=600).pixels[..., :3]
    assert np.isfinite(staged).all()
    assert abs(staged.mean() - plain.mean()) < 0.02
