"""AccPathTracer tests: BSDF dispatch, conductor/glass/microfacet physics."""
import numpy as np
import pytest

import jax.numpy as jnp

import nrenderer_tpu
from nrenderer_tpu import load_scn
from nrenderer_tpu.server.manager import ComponentManager
from nrenderer_tpu.ops.soa import V3
from nrenderer_tpu.ops.pt_core import (
    conductor_scatter, fresnel_conductor, glass_scatter, microfacet_scatter,
)

nrenderer_tpu._register_builtin_renderers()


def render(resource_dir, name, w=48, h=48, spp=8, depth=6, mutate=None):
    scene = load_scn(str(resource_dir / name))
    scene.render_option.width = w
    scene.render_option.height = h
    scene.render_option.samples_per_pixel = spp
    scene.render_option.depth = depth
    if mutate:
        mutate(scene)
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", scene)
    return mgr.wait(timeout=600).pixels


def v3s(*vals):
    return V3(jnp.asarray([vals[0]], jnp.float32),
              jnp.asarray([vals[1]], jnp.float32),
              jnp.asarray([vals[2]], jnp.float32))


def test_fresnel_conductor_normal_incidence():
    """At normal incidence F = ((n-1)^2 + k^2) / ((n+1)^2 + k^2)."""
    eta_r = v3s(0.142, 0.374, 1.439)   # gold
    eta_i = v3s(3.974, 2.380, 1.599)
    f = fresnel_conductor(jnp.asarray([1.0]), eta_r, eta_i)
    for ch, n, k in (("x", 0.142, 3.974), ("y", 0.374, 2.380),
                     ("z", 1.439, 1.599)):
        expect = ((n - 1) ** 2 + k ** 2) / ((n + 1) ** 2 + k ** 2)
        assert float(getattr(f, ch)[0]) == pytest.approx(expect, rel=1e-4)


def test_conductor_mirror_direction():
    d = v3s(0.0, -np.sqrt(0.5), np.sqrt(0.5))
    n = v3s(0.0, 1.0, 0.0)
    l, att = conductor_scatter(d, n, v3s(0.1, 0.1, 0.1), v3s(3, 3, 3),
                               v3s(1, 1, 1))
    # reflect about y: (0, +s, s)
    assert float(l.y[0]) == pytest.approx(np.sqrt(0.5), abs=1e-5)
    assert float(l.z[0]) == pytest.approx(np.sqrt(0.5), abs=1e-5)
    assert float(att.x[0]) > 0


def test_glass_reflect_refract_split():
    d = v3s(0.0, -1.0, 0.0)
    n = v3s(0.0, 1.0, 0.0)
    ior = jnp.asarray([1.5], jnp.float32)
    absorbed = v3s(1.0, 1.0, 1.0)
    # u below F -> reflect (F ~ 0.04 at normal incidence)
    l_r, w_r = glass_scatter(d, n, ior, absorbed, jnp.asarray([0.0]))
    assert float(l_r.y[0]) == pytest.approx(1.0, abs=1e-5)
    # u above F -> refract; at normal incidence the reference's construction
    # gives x_ = 0 -> straight through along -N
    l_t, w_t = glass_scatter(d, n, ior, absorbed, jnp.asarray([0.999]))
    assert float(l_t.y[0]) == pytest.approx(-1.0, abs=1e-4)
    np.testing.assert_allclose(np.asarray(w_t.x), 1.0)


def test_glass_tir_reflects():
    # from inside (dot(V,N)>0) at grazing angle -> x_ > 1 -> TIR
    d = v3s(np.sqrt(0.96), 0.2, 0.0)  # mostly along +x, slightly +y
    n = v3s(0.0, 1.0, 0.0)
    ior = jnp.asarray([1.5], jnp.float32)
    l, w = glass_scatter(d, n, ior, v3s(1, 1, 1), jnp.asarray([0.999]))
    # reflected: y flips
    assert float(l.y[0]) == pytest.approx(-0.2, abs=1e-4)


def test_microfacet_zero_rough_is_mirror():
    d = v3s(0.0, -np.sqrt(0.5), np.sqrt(0.5))
    n = v3s(0.0, 1.0, 0.0)
    l, att = microfacet_scatter(d, n, v3s(1, 1, 1),
                                jnp.asarray([1e-4]), jnp.asarray([0.04]),
                                jnp.asarray([0.2]), jnp.asarray([0.3]),
                                jnp.asarray([0.7]))
    # nearly mirror about n
    assert float(l.y[0]) == pytest.approx(np.sqrt(0.5), abs=1e-2)
    assert np.isfinite(float(att.x[0]))


def test_pt_glass_scene(resource_dir):
    img = render(resource_dir, "pt_glass.scn", spp=16)
    assert np.isfinite(img).all()
    assert img[..., :3].max() > 0.05  # lit by the area light


def test_conductors_scene(resource_dir):
    """conductors.scn has only type-3 (microfacet) spheres and no light;
    must run without NaNs and stay black (nothing emits)."""
    img = render(resource_dir, "conductors.scn", spp=4, depth=4)
    assert np.isfinite(img).all()


def test_plastic_scatter_lobes():
    """Plastic (type 4): u3 below the Schlick F picks the mirror-specular
    lobe (weight = specularColor), above it the diffuse lobe."""
    from nrenderer_tpu.ops.pt_core import plastic_scatter
    d = v3s(0.0, -1.0, 0.0)
    n = v3s(0.0, 1.0, 0.0)
    ior = jnp.asarray([1.5], jnp.float32)
    diffuse = v3s(0.6, 0.2, 0.1)
    specular = v3s(0.9, 0.8, 0.7)
    # F0 = (0.5/2.5)^2 = 0.04 at normal incidence
    l_s, w_s = plastic_scatter(d, n, diffuse, specular, ior,
                               jnp.asarray([0.3]), jnp.asarray([0.7]),
                               jnp.asarray([0.0]))
    assert float(l_s.y[0]) == pytest.approx(1.0, abs=1e-5)
    assert float(w_s.x[0]) == pytest.approx(0.9, abs=1e-6)
    l_d, w_d = plastic_scatter(d, n, diffuse, specular, ior,
                               jnp.asarray([0.3]), jnp.asarray([0.7]),
                               jnp.asarray([0.999]))
    cos_d = float(l_d.y[0])
    assert cos_d > 0  # diffuse stays in the upper hemisphere
    assert float(w_d.x[0]) == pytest.approx(0.6 * 2.0 * cos_d, rel=1e-4)


def test_plastic_template_renders(resource_dir):
    """A template-instantiated Plastic material renders via AccPathTracer:
    brighter than pure diffuse of the same color under the same light (the
    specular lobe adds light-carrying mirror paths), finite everywhere."""
    from nrenderer_tpu.scene.templates import make_material
    from nrenderer_tpu.scene.model import Property, PropertyType

    def to_plastic(scene):
        # retype the tall-box material (index varies; use the first
        # non-wall material) as Plastic with the same diffuse color
        mat = make_material("Plastic", name="plastic")
        mat.register_property(Property("diffuseColor", PropertyType.RGB,
                                       (0.725, 0.71, 0.68)))
        scene.materials[0] = mat

    img = render(resource_dir, "path_tracing_cornel.scn", spp=16,
                 mutate=to_plastic)
    assert np.isfinite(img).all()
    assert img[..., :3].max() > 0.05


def test_matches_simple_pt_on_diffuse_scene(resource_dir):
    """On an all-Lambertian scene AccPathTracer and SimplePathTracer sample
    the same estimator -> images agree within MC noise."""
    a = render(resource_dir, "path_tracing_cornel.scn", spp=64, depth=4)
    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    scene.render_option.width = 48
    scene.render_option.height = 48
    scene.render_option.samples_per_pixel = 64
    scene.render_option.depth = 4
    mgr = ComponentManager()
    mgr.exec("SimplePathTracer", scene)
    b = mgr.wait(timeout=600).pixels
    diff = np.abs(a[..., :3].mean() - b[..., :3].mean())
    assert diff < 0.03


def test_acc_type_knob(resource_dir):
    """`acc_type` (reference Scene.hpp:23, stored-but-dead there) is live
   : 0 forces brute force, 1 = size heuristic,
    2 forces the mesh engine; impossible brute-force requests are
    refused with a log line, not a hung compile."""
    import nrenderer_tpu
    from nrenderer_tpu.io.obj import load_obj
    from nrenderer_tpu.server.registry import get_server
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer

    def render(acc_type, faces="bunny_200_faces.obj"):
        s = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
        load_obj(str(resource_dir / "obj" / faces), s, material=0)
        m = s.models[-1]
        m.scale = (400.0,) * 3
        m.translation = (40.0, -305.0, 920.0)
        s.render_option.width = s.render_option.height = 16
        s.render_option.samples_per_pixel = 2
        s.render_option.depth = 3
        s.render_option.acc_type = acc_type
        get_server().logger.clear()
        r = AccPathTracerRenderer(seed=0).render(s)
        msgs = " | ".join(m.content for m in get_server().logger.get())
        return np.asarray(r.pixels), msgs

    img1, log1 = render(1)  # 200 tris > threshold -> accelerated
    assert "mesh engine over" in log1
    img0, log0 = render(0)  # forced brute force
    assert "mesh engine over" not in log0
    assert np.isfinite(img0).all()
    # same estimator, same seed: engines agree numerically
    np.testing.assert_allclose(img0, img1, atol=5e-5)
    # acc_type=0 on a huge pool is refused (would unroll 5k triangles)
    _, log_refuse = render(0, faces="bunny_5k_faces.obj")
    assert "refused" in log_refuse and "mesh engine over" in log_refuse


def test_acc_type_2_forces_accel(resource_dir):
    import nrenderer_tpu
    from nrenderer_tpu.server.registry import get_server
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.renderers.acc_pt import AccPathTracerRenderer
    s = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    s.render_option.width = s.render_option.height = 8
    s.render_option.samples_per_pixel = 2
    s.render_option.depth = 2
    s.render_option.acc_type = 2  # tiny pool, accel anyway
    get_server().logger.clear()
    AccPathTracerRenderer(seed=0).render(s)
    msgs = " | ".join(m.content for m in get_server().logger.get())
    assert "mesh engine over" in msgs
