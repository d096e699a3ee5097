"""GPU megakernel coverage on the CPU: the Triton-route kernel in interpret
mode against its plain reference, its wrapper's shapes and padding, its
lowering for CUDA, and the engine choice.  The compiled kernel runs in the
`gpu`-marked test on the card."""
import numpy as np
import pytest

import jax.numpy as jnp

from nrenderer_tpu import Camera, Scene, build_scene_arrays, load_scn
from nrenderer_tpu.ops import pt_pallas
from nrenderer_tpu.ops.camera import make_camera
from nrenderer_tpu.ops.intersect import make_static_scene
from nrenderer_tpu.renderers.engine import MEGAKERNEL, XLA, choose_engine


def _setup(resource_dir, name):
    scene = load_scn(str(resource_dir / name))
    arr = build_scene_arrays(scene)
    return arr, make_static_scene(arr), make_camera(scene.camera)


@pytest.fixture(scope="module")
def cornel(resource_dir):
    return _setup(resource_dir, "path_tracing_cornel.scn")


@pytest.fixture(scope="module")
def glass(resource_dir):
    return _setup(resource_dir, "pt_glass.scn")


@pytest.mark.parametrize("bsdf", [False, True], ids=["diffuse", "bsdf"])
def test_kernel_matches_plain_reference_per_pixel(cornel, glass, bsdf):
    """Same estimator, same hash draws: the interpreted kernel and the
    whole-film jnp reference agree pixel by pixel.  20 x 13 = 260 pixels
    is not a multiple of BLOCK, so the padded last block is covered."""
    _, ss, cam = glass if bsdf else cornel
    w, h, spp, depth = 20, 13, 3, 4
    k = np.asarray(pt_pallas.render_pt_pallas_linear(
        ss, cam, w, h, spp, depth, seed=7, bsdf=bsdf, interpret=True))
    r = np.asarray(pt_pallas.render_reference_linear(
        ss, cam, w, h, spp, depth, seed=7, bsdf=bsdf))
    assert k.shape == r.shape == (w * h, 3)
    assert np.isfinite(k).all() and k.max() > 0.0
    np.testing.assert_allclose(k, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w,h", [(5, 7), (16, 8), (17, 9)])
def test_wrapper_shapes_and_padding(cornel, w, h):
    """Films smaller than, equal to and just past one block."""
    _, ss, cam = cornel
    lin = pt_pallas.render_pt_pallas_linear(ss, cam, w, h, 1, 2, seed=1,
                                            interpret=True)
    assert lin.shape == (w * h, 3)
    img = pt_pallas.render_simple_pt_pallas(ss, cam, w, h, 1, 2, seed=1,
                                            interpret=True)
    assert img.shape == (h, w, 3)
    np.testing.assert_allclose(np.asarray(img).reshape(-1, 3),
                               np.sqrt(np.maximum(np.asarray(lin), 0.0)),
                               rtol=1e-6)


def test_seeds_give_independent_passes(cornel):
    _, ss, cam = cornel
    a = np.asarray(pt_pallas.render_reference_linear(ss, cam, 8, 8, 2, 3,
                                                     seed=1))
    b = np.asarray(pt_pallas.render_reference_linear(ss, cam, 8, 8, 2, 3,
                                                     seed=1))
    c = np.asarray(pt_pallas.render_reference_linear(ss, cam, 8, 8, 2, 3,
                                                     seed=2))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_empty_scene_is_refused():
    ss = make_static_scene(build_scene_arrays(Scene()))
    cam = make_camera(Camera())
    with pytest.raises(ValueError, match="at least one primitive"):
        pt_pallas.render_pt_pallas_linear(ss, cam, 4, 4, 1, 1,
                                          interpret=True)


def test_reference_matches_xla_wavefront_statistically(cornel):
    """The hash-RNG estimator and the jax.random XLA wavefront are two
    independent realisations of one estimator: their image means agree
    within 3 sigma of the Monte Carlo error."""
    arr, ss, cam = cornel
    w = h = 16
    spp, depth = 64, 4
    from nrenderer_tpu.ops.sampling import make_base_key
    from nrenderer_tpu.renderers.simple_pt import build_linear_chunk_fn
    ref = np.asarray(pt_pallas.render_reference_linear(
        ss, cam, w, h, spp, depth, seed=0)) / spp
    fn = build_linear_chunk_fn(ss, w, h, depth, spp, False, False)
    xla = np.asarray(fn(cam, arr.env_map, make_base_key(0), 0)) / spp
    # per-pixel error of a spp-sample mean, from 4 independent passes
    n = 4
    passes = np.stack([np.asarray(pt_pallas.render_reference_linear(
        ss, cam, w, h, spp // n, depth, seed=s)) / (spp // n)
        for s in range(1, n + 1)])
    sigma_px = passes.std(axis=0, ddof=1) / np.sqrt(n)
    sigma_mean = np.sqrt((sigma_px ** 2).sum()) / sigma_px.size
    diff = abs(ref.mean() - xla.mean())
    assert diff < 3.0 * np.sqrt(2.0) * sigma_mean, (diff, sigma_mean)


@pytest.mark.parametrize("bsdf", [False, True], ids=["diffuse", "bsdf"])
def test_kernel_lowers_for_cuda(cornel, glass, bsdf):
    """The kernel at the north-star width lowers through Pallas' Triton
    route for CUDA: every primitive it uses has a Triton lowering.  (The
    GPU compiler itself runs only on the card.)"""
    _, ss, cam = glass if bsdf else cornel
    run = pt_pallas._build_kernel(
        pt_pallas._hashable_static_scene(ss), pt_pallas._camera_tuple(cam),
        512, 512, 64, 20, pt_pallas.scene_epsilon(ss), bsdf, False,
        (pt_pallas.BLOCK, pt_pallas.NUM_WARPS, pt_pallas.NUM_STAGES))
    lowered = run.trace(jnp.asarray([0], jnp.int32)).lower(
        lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text().lower()


class _Prims:
    """The StaticScene fields the engine choice reads."""

    def __init__(self, n_sph=1, ambient_type=0):
        self.sph = [(0.0, 0.0, 0.0, 1.0, 0)] * n_sph
        self.tri, self.pln = [], []
        self.ambient_type = ambient_type


@pytest.mark.parametrize("platform,case,expected", [
    ("gpu", "dense", MEGAKERNEL),
    ("cpu", "dense", XLA),
    ("gpu", "mesh", XLA),
    ("gpu", "lens", XLA),
    ("gpu", "textures", XLA),
    ("gpu", "env", XLA),
    ("gpu", "empty", XLA),
])
def test_engine_choice(platform, case, expected):
    ss = _Prims(n_sph=0 if case == "empty" else 1,
                ambient_type=1 if case == "env" else 0)
    got = choose_engine(
        ss, mesh=case == "mesh", has_lens=case == "lens",
        textures=(np.zeros((2, 2, 3)),) if case == "textures" else None,
        platform=platform)
    assert got == expected


@pytest.mark.gpu
@pytest.mark.parametrize("bsdf", [False, True], ids=["diffuse", "bsdf"])
def test_compiled_kernel_matches_reference_on_card(gpu, cornel, glass, bsdf):
    """On the card: the compiled kernel against the plain reference at a
    real width.  FMA contraction can flip a rare hit or roulette branch,
    so the bound is on the mean and on the share of outlying pixels."""
    _, ss, cam = glass if bsdf else cornel
    w = h = 256
    spp, depth = 16, 20
    k = np.asarray(pt_pallas.render_pt_pallas_linear(
        ss, cam, w, h, spp, depth, seed=3, bsdf=bsdf)) / spp
    r = np.asarray(pt_pallas.render_reference_linear(
        ss, cam, w, h, spp, depth, seed=3, bsdf=bsdf)) / spp
    d = np.abs(k - r)
    assert d.mean() <= 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() <= 1e-3


@pytest.fixture
def megakernel_on_cpu(monkeypatch):
    """Route the renderers' GPU branch to the interpreted megakernel, so
    their wiring (engine choice, seeds, orientation, checkpoints) runs on
    the CPU."""
    from nrenderer_tpu.renderers import acc_pt, simple_pt
    for mod in (acc_pt, simple_pt):
        monkeypatch.setattr(mod, "choose_engine",
                            lambda *a, **k: MEGAKERNEL)
    kernel = pt_pallas.render_pt_pallas_linear
    monkeypatch.setattr(pt_pallas, "render_pt_pallas_linear",
                        lambda *a, **k: kernel(*a, **{**k, "interpret": True}))


def _expected_image(ss, cam, w, h, spp, depth, seed, bsdf):
    """The renderers' contract: sqrt-gamma of the linear film, row 0 = top,
    clipped to [0, 1]."""
    lin = np.asarray(pt_pallas.render_reference_linear(
        ss, cam, w, h, spp, depth, seed=seed, bsdf=bsdf)) / spp
    img = np.sqrt(np.maximum(lin, 0.0)).reshape(h, w, 3)[::-1]
    return np.clip(img, 0.0, 1.0)


@pytest.mark.parametrize("renderer,scene,bsdf", [
    ("SimplePathTracer", "path_tracing_cornel.scn", False),
    ("AccPathTracer", "pt_glass.scn", True),
])
def test_renderer_megakernel_branch(megakernel_on_cpu, resource_dir,
                                    renderer, scene, bsdf):
    """A renderer that picks the megakernel returns the kernel's film, the
    right way up, at its own seed."""
    import nrenderer_tpu
    from nrenderer_tpu.server.manager import ComponentManager
    nrenderer_tpu._register_builtin_renderers()
    s = load_scn(str(resource_dir / scene))
    w, h, spp, depth = 12, 10, 2, 3
    ro = s.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    mgr = ComponentManager()
    mgr.exec(renderer, s)
    got = np.asarray(mgr.wait(timeout=600).pixels)[..., :3]
    arr = build_scene_arrays(s)
    want = _expected_image(make_static_scene(arr), make_camera(s.camera),
                           w, h, spp, depth, 0, bsdf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("renderer", ["SimplePathTracer", "AccPathTracer"])
def test_renderer_megakernel_checkpointed(megakernel_on_cpu, resource_dir,
                                          tmp_path, renderer):
    """The checkpointed megakernel branches (a pass per launch, the film
    snapshotted between them) finish with a finite image and a snapshot."""
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer
    s = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    ro = s.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = 8, 8, 8, 2
    ck = tmp_path / "ck.npz"
    cls = (SimplePathTracerRenderer if renderer == "SimplePathTracer"
           else AccPathTracerRenderer)
    img = np.asarray(cls(seed=1, checkpoint_path=str(ck)).render(s).pixels)
    assert img.shape == (8, 8, 4) and np.isfinite(img).all()
    assert img[..., :3].max() > 0.0
    assert ck.exists()
