"""CLI surface tests: routing, error paths, and end-to-end renders.

The CLI replaces the reference's GUI workflow (SURVEY §2.10 / §5.6:
import -> configure -> render -> result); these tests pin its contract —
exit codes, error messages on bad input, render output files — the way
the reference's workflow was only ever checked by hand.
"""
import numpy as np
import pytest

from nrenderer_tpu.cli import main

from nrenderer_tpu.resources import RESOURCE_DIR

RES = str(RESOURCE_DIR)


def test_list_renderers(capsys):
    assert main(["list-renderers"]) == 0
    out = capsys.readouterr().out
    for name in ("NR.Render.RayCast", "NR.Render.SimplePathTracer",
                 "NR.Render.AccPathTracer",
                 "NR.Render.MetropolisLightTransport", "NR.Render.Example"):
        assert name in out


def test_render_raycast_writes_png(tmp_path, capsys):
    out = tmp_path / "rc.png"
    rc = main(["render", "--scene", f"{RES}/ray_cast_cornel.scn",
               "--renderer", "RayCast", "--width", "32", "--height", "32",
               "--out", str(out)])
    assert rc == 0
    assert out.exists()
    from nrenderer_tpu.io.image import load_image
    img = load_image(str(out))
    assert img.shape[:2] == (32, 32)
    assert img.max() > 0.05  # lit scene, not black


def test_unknown_renderer_lists_available(tmp_path, capsys):
    rc = main(["render", "--scene", f"{RES}/ray_cast_cornel.scn",
               "--renderer", "NoSuch", "--width", "8", "--height", "8",
               "--out", str(tmp_path / "x.png")])
    assert rc == 2
    err = capsys.readouterr().err
    assert "unknown renderer" in err and "RayCast" in err


def test_scene_parse_error_is_reported(tmp_path, capsys):
    bad = tmp_path / "bad.scn"
    bad.write_text("Scene {\n  garbage that is not a directive\n")
    rc = main(["render", "--scene", str(bad), "--renderer", "RayCast",
               "--width", "8", "--height", "8",
               "--out", str(tmp_path / "x.png")])
    assert rc == 2
    assert "scene import failed" in capsys.readouterr().err


def test_shard_pixels_rejects_mlt(tmp_path, capsys):
    rc = main(["render", "--scene", f"{RES}/Metropolis.scn",
               "--renderer", "MetropolisLightTransport",
               "--devices", "2", "--shard", "pixels",
               "--width", "8", "--height", "8",
               "--out", str(tmp_path / "x.png")])
    assert rc == 2
    assert "--shard pixels" in capsys.readouterr().err


def test_shard_pixels_rejects_indivisible_height(tmp_path, capsys):
    rc = main(["render", "--scene", f"{RES}/path_tracing_cornel.scn",
               "--renderer", "SimplePathTracer",
               "--devices", "3", "--shard", "pixels",
               "--width", "8", "--height", "8", "--spp", "3",
               "--out", str(tmp_path / "x.png")])
    assert rc == 2
    assert "divisible" in capsys.readouterr().err


def test_too_many_devices_is_an_error(tmp_path, capsys):
    rc = main(["render", "--scene", f"{RES}/path_tracing_cornel.scn",
               "--renderer", "SimplePathTracer",
               "--devices", "99", "--width", "8", "--height", "8",
               "--spp", "99", "--out", str(tmp_path / "x.png")])
    assert rc == 2
    assert "devices" in capsys.readouterr().err


def test_checkpoint_composes_with_devices(tmp_path, capsys, monkeypatch):
    """--checkpoint + --devices render resumably: a run killed after its
    first snapshot resumes to the image of an uninterrupted checkpointed
    run.  The film is a sum across devices and passes (atomics on the GPU,
    in no fixed order), so the 8-bit images agree to one step, not bit for
    bit."""
    import nrenderer_tpu.server.checkpoint as ckpt

    argv = ["render", "--scene", f"{RES}/path_tracing_cornel.scn",
            "--renderer", "SimplePathTracer", "--devices", "2",
            "--width", "8", "--height", "8", "--spp", "8", "--depth", "2"]
    out1, out2 = tmp_path / "a.png", tmp_path / "b.png"
    ck = tmp_path / "ck.npz"
    assert main(argv + ["--checkpoint", str(ck), "--out", str(out1)]) == 0
    assert ck.exists()

    real_save = ckpt.save_checkpoint
    calls = {"n": 0}

    def dying_save(*a, **k):
        real_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    ck2 = tmp_path / "ck2.npz"
    monkeypatch.setattr(ckpt, "save_checkpoint", dying_save)
    with pytest.raises(KeyboardInterrupt):
        main(argv + ["--checkpoint", str(ck2), "--out", str(out2)])
    monkeypatch.setattr(ckpt, "save_checkpoint", real_save)
    assert int(np.load(ck2)["spp_done"]) < 8  # genuinely interrupted

    assert main(argv + ["--checkpoint", str(ck2), "--out", str(out2)]) == 0
    from nrenderer_tpu.io.image import load_image
    np.testing.assert_allclose(load_image(str(out1)),
                               load_image(str(out2)), atol=1.0 / 255)


def test_acc_checkpoint_roundtrip_via_cli(tmp_path, capsys, monkeypatch):
    """--checkpoint on AccPathTracer: first run writes the snapshot file,
    second run resumes to the identical image."""
    import nrenderer_tpu.renderers.acc_pt as acc
    monkeypatch.setattr(acc, "pick_chunk", lambda *a, **k: 4)
    out1, out2 = tmp_path / "a.png", tmp_path / "b.png"
    ck = tmp_path / "acc.npz"
    argv = ["render", "--scene", f"{RES}/path_tracing_cornel.scn",
            "--renderer", "AccPathTracer", "--checkpoint", str(ck),
            "--width", "16", "--height", "16", "--spp", "8", "--depth", "3"]
    assert main(argv + ["--out", str(out1)]) == 0
    assert ck.exists()
    assert main(argv + ["--out", str(out2)]) == 0
    from nrenderer_tpu.io.image import load_image
    np.testing.assert_allclose(load_image(str(out1)),
                               load_image(str(out2)), atol=1.0 / 255)


def test_env_map_flag(tmp_path, capsys):
    """--env-map switches ambient to ENVIRONMENT_MAP and renders misses."""
    from nrenderer_tpu.io.image import write_png
    em = tmp_path / "env.png"
    px = np.zeros((8, 16, 3), np.float32)
    px[:, :, 2] = 1.0  # uniform blue sky
    write_png(str(em), px)
    out = tmp_path / "e.png"
    rc = main(["render", "--scene", f"{RES}/env_map_spheres.scn",
               "--renderer", "AccPathTracer", "--env-map", str(em),
               "--width", "16", "--height", "16", "--spp", "4",
               "--depth", "3", "--out", str(out)])
    assert rc == 0
    from nrenderer_tpu.io.image import load_image
    img = load_image(str(out))
    # sky-dominated scene: blue channel should clearly lead
    assert img[..., 2].mean() > img[..., 0].mean()
