"""PhaseTimer tests (aux subsystem, SURVEY §5.1)."""
import time

from nrenderer_tpu.utils.timing import PhaseTimer
from nrenderer_tpu.resources import RESOURCE_DIR


def test_phase_accumulation():
    t = PhaseTimer()
    with t.phase("compile"):
        time.sleep(0.01)
    with t.phase("compile"):
        time.sleep(0.01)
    with t.phase("execute"):
        pass
    st = t.get("compile")
    assert st.count == 2
    assert st.total_s >= 0.02
    report = t.report()
    assert "compile" in report and "execute" in report
    t.clear()
    assert t.get("compile").count == 0


def test_manual_add():
    t = PhaseTimer()
    t.add("transfer", 1.5)
    t.add("transfer", 0.5)
    assert t.get("transfer").total_s == 2.0


def test_summary_line():
    t = PhaseTimer()
    t.add("prep", 0.12)
    t.add("render", 1.5)
    t.add("render", 1.5)
    s = t.summary()
    assert "prep 0.12s" in s and "render 3.00s x2" in s and " | " in s


def test_renderers_log_phases():
    """Every render logs a 'phases:' line to the server Logger
    (the reference printed per-thread intersect timing,
    `SimplePathTracer.cpp:90-94`)."""
    import nrenderer_tpu
    from nrenderer_tpu import load_scn
    from nrenderer_tpu.server.registry import get_server

    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.renderers.raycast import RayCastRenderer
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer

    scene = load_scn(str(RESOURCE_DIR / "ray_cast_cornel.scn"))
    scene.render_option.width = scene.render_option.height = 16
    get_server().logger.clear()
    RayCastRenderer().render(scene)
    assert any("phases:" in m.content for m in get_server().logger.get())

    scene = load_scn(str(RESOURCE_DIR / "path_tracing_cornel.scn"))
    ro = scene.render_option
    ro.width = ro.height = 16
    ro.samples_per_pixel = 4
    ro.depth = 2
    get_server().logger.clear()
    SimplePathTracerRenderer().render(scene)
    msgs = [m.content for m in get_server().logger.get()]
    assert any("phases:" in m and "render[" in m for m in msgs)
