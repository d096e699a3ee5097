"""MLT golden-image regression against the plain unbiased path tracer.

The reference is a SimplePathTracer render of the same scene (unbiased,
checked itself against the megakernel's plain reference in
tests/test_golden.py), tone-mapped with MLT's own exposure curve
`pow(1 - exp(-x), 1/2.2)` so both images live in one domain.  The top band
holding the light quad is excluded: MinPathLength=3 removes the direct
camera->light path from MLT (`PathContribution.hpp:13`).  Structure (wall
colors, the caustic cube glow, shadows) must correlate; absolute exposure
must match after mean-scaling, and within a wide band before it (two
preserved REFQUIRKs keep MLT from matching exactly: emitted = 2x the scene
radiance, `Metropolis.hpp:34`, and light-vert getColor returning emitted —
docs/architecture.md divergence #9).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # ~10 min of CPU renders

from nrenderer_tpu import load_scn
from nrenderer_tpu.resources import RESOURCE_DIR

W = H = 64
BAND = H // 6  # the light quad's rows


def _down(a, size=16):
    """Block means on a size x size grid (blocks differ by at most 1 px)."""
    rows = np.array_split(np.arange(a.shape[0]), size)
    cols = np.array_split(np.arange(a.shape[1]), size)
    return np.array([[a[r][:, c].mean(axis=(0, 1)) for c in cols]
                     for r in rows])


@pytest.fixture(scope="module")
def images():
    from nrenderer_tpu.renderers.mlt import render_mlt
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer

    def scene():
        s = load_scn(str(RESOURCE_DIR / "Metropolis.scn"))
        s.render_option.width = W
        s.render_option.height = H
        s.render_option.depth = 8
        return s
    s = scene()
    s.render_option.samples_per_pixel = 256
    pt = SimplePathTracerRenderer(seed=0).render(s).pixels[..., :3]
    ref = (1.0 - np.exp(-pt.astype(np.float64) ** 2)) ** (1 / 2.2)
    img = render_mlt(scene(), chains=384, mutations=64, n_init=3072,
                     seed=0)[..., :3].astype(np.float64)
    return _down(img[BAND:BAND + 48]), _down(ref[BAND:BAND + 48])


def test_mlt_structure_matches_reference(images):
    ours, ref = images
    corr = np.corrcoef(ours.reshape(-1), ref.reshape(-1))[0, 1]
    assert corr > 0.7, corr


def test_mlt_normalized_rmse(images):
    ours, ref = images
    scaled = ours * (ref.mean() / max(ours.mean(), 1e-6))
    rmse = float(np.sqrt(((scaled - ref) ** 2).mean()))
    assert rmse < 0.16, rmse


def test_mlt_brightness_tracks_unbiased_pt(images):
    """Tone-mapped brightness tracks the unbiased PT through the same
    curve; the band is wide for the CI chain budget."""
    ours, ref = images
    assert 0.6 < ours.mean() / ref.mean() < 1.6, (ours.mean(), ref.mean())


def test_mlt_linear_radiance_vs_unbiased_pt():
    """the ground-truth cross-check asserted as a test.
    Render `Metropolis.scn` with SimplePathTracer (unbiased) and assert our
    MLT's LINEAR radiance tracks it.

    The tone map `pow(1 - exp(-x*s), 1/2.2)` is inverted to recover the
    per-pixel linear estimate.  The top band containing the light quad is
    excluded: MinPathLength=3 removes the direct camera->light path from
    MLT (`PathContribution.hpp:13`) so the two estimators legitimately
    differ there.  Two preserved REFQUIRKs keep the agreement from being
    exact anywhere (docs/architecture.md #9): emitted = 2x the scene
    radiance (`Metropolis.hpp:34`) and light-vert getColor returning
    emitted — the latter produces the reference's signature "cube glow"
    that the unbiased render does not have (visible in the reference's own
    `results/MLT.png`).  Calibrated at 2x this budget: masked mean ratio
    1.08, per-channel r 1.23 / g 1.01 / b 0.79, tone corr 0.87 full-image.
    A broken MIS weight, palette, or splat path moves these far outside
    the bands."""
    import jax  # noqa: F401  (forces backend init before both renders)
    from nrenderer_tpu.renderers.mlt import render_mlt
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer

    W = H = 48
    DEPTH = 8

    def scene():
        s = load_scn(str(RESOURCE_DIR / "Metropolis.scn"))
        s.render_option.width = W
        s.render_option.height = H
        s.render_option.depth = DEPTH
        return s

    s = scene()
    s.render_option.samples_per_pixel = 512
    pt = SimplePathTracerRenderer(seed=0).render(s).pixels[..., :3]
    pt_lin = pt.astype(np.float64) ** 2  # sqrt gamma undone

    img = render_mlt(scene(), chains=1024, mutations=256, n_init=8192,
                     seed=0)
    rgb = img[..., :3].astype(np.float64)
    mlt_lin = -np.log1p(-np.clip(rgb, 0.0, 0.999999) ** 2.2)

    band = H // 6  # the light quad's rows
    a, b = mlt_lin[band:], pt_lin[band:]
    ratio = a.mean() / b.mean()
    assert 0.85 < ratio < 1.30, ratio  # 1.08 calibrated
    for i, (lo, hi) in enumerate([(0.95, 1.55), (0.8, 1.3), (0.6, 1.05)]):
        r = a[..., i].mean() / b[..., i].mean()
        assert lo < r < hi, (i, r)
    # full-image structure (light + walls + floor): tone-domain corr
    dn = _down(rgb, 12).reshape(-1)
    dp = _down(pt, 12).reshape(-1)
    corr = np.corrcoef(dn, dp)[0, 1]
    assert corr > 0.75, corr  # 0.87 calibrated at 2x budget


def test_mlt_mesh_scene_vs_unbiased_pt():
    """MLT mesh capability: the reference
    MLT brute-forces ANY scene, mesh-expanded triangles included
    (`Metropolis.cpp:135-166`); here triangle pools past MLT_BVH_THRESHOLD
    route through the mesh engine, so a bunny mesh + area light
    scene must compile AND track the unbiased path-trace of the same
    scene.  Ground truth is AccPathTracer (identical estimator to
    SimplePathTracer on this all-Lambertian scene — their agreement is
    golden-tested separately — and its mesh path is equality-tested
    against brute force), at the same depth.  Bands account for the two
    preserved REFQUIRKs (emitted = 2x radiance, light-vert getColor =
    emitted) exactly like test_mlt_linear_radiance_vs_unbiased_pt."""
    from nrenderer_tpu.io.obj import load_obj
    from nrenderer_tpu.renderers.mlt import render_mlt, _prepare_mlt
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer

    W = H = 32
    DEPTH = 6

    def scene():
        s = load_scn(str(RESOURCE_DIR / "Metropolis.scn"))
        load_obj(str(RESOURCE_DIR / "obj" / "bunny_200_faces.obj"), s,
                 material=0)
        m = s.models[-1]
        m.scale = (400.0,) * 3
        m.translation = (40.0, -305.0, 920.0)
        s.render_option.width = W
        s.render_option.height = H
        s.render_option.depth = DEPTH
        return s

    # the mesh path actually engages (200 tris > threshold 64)
    kern, _, _ = _prepare_mlt(scene(), DEPTH)
    assert kern.tri_bvh is not None

    s = scene()
    s.render_option.samples_per_pixel = 256
    pt = AccPathTracerRenderer(seed=0).render(s).pixels[..., :3]
    pt_lin = pt.astype(np.float64) ** 2  # sqrt gamma undone

    img = render_mlt(scene(), chains=512, mutations=128, n_init=4096,
                     seed=0)
    rgb = img[..., :3].astype(np.float64)
    assert np.isfinite(rgb).all()
    mlt_lin = -np.log1p(-np.clip(rgb, 0.0, 0.999999) ** 2.2)

    band = H // 6  # exclude the light quad's rows (MinPathLength=3)
    a, b = mlt_lin[band:], pt_lin[band:]
    ratio = a.mean() / b.mean()
    assert 0.8 < ratio < 1.4, ratio
    # structure: the bunny occludes/bounces where the PT says it does
    dn = _down(rgb, 12).reshape(-1)
    dp = _down(pt, 12).reshape(-1)
    corr = np.corrcoef(dn, dp)[0, 1]
    assert corr > 0.7, corr
