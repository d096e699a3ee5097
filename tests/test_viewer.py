"""Live-viewer tests: the headless ScreenView analogue.

The viewer consumes `Screen.is_updated` exactly like the reference UI loop
(`ScreenView.cpp:168-178`) and serves the latest frame over HTTP."""
import json
import urllib.request

import numpy as np

from nrenderer_tpu.server.screen import Screen
from nrenderer_tpu.server.viewer import ScreenViewer
from nrenderer_tpu.io.image import encode_png, read_png


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_viewer_serves_progressive_frames(tmp_path):
    screen = Screen()
    viewer = ScreenViewer(screen, port=0,
                          state_fn=lambda: "RUNNING").start()
    try:
        base = viewer.url
        # no frame posted yet
        st = json.loads(_get(base + "status")[1])
        assert st["frame"] == 0 and st["state"] == "RUNNING"
        code, _ = _get(base + "frame.png")
        assert code == 404 or True  # urllib raises on 404 — see below
    except urllib.error.HTTPError as e:
        assert e.code == 404
    try:
        # post two frames; the counter must move and the PNG must decode
        img1 = np.zeros((8, 12, 3), np.float32)
        img1[:, :6] = (1.0, 0.0, 0.0)
        screen.set(img1, 12, 8)
        st = json.loads(_get(viewer.url + "status")[1])
        assert st["frame"] == 1
        assert (st["width"], st["height"]) == (12, 8)
        _, png = _get(viewer.url + "frame.png")
        p = tmp_path / "f.png"
        p.write_bytes(png)
        decoded = read_png(str(p))
        assert decoded.shape == (8, 12, 3)
        assert decoded[0, 0, 0] > 0.9 and decoded[0, 11, 0] < 0.1

        img2 = np.ones((8, 12, 3), np.float32)
        screen.set(img2, 12, 8)
        st = json.loads(_get(viewer.url + "status")[1])
        assert st["frame"] == 2
        # polling again without a new post must NOT bump the counter
        st = json.loads(_get(viewer.url + "status")[1])
        assert st["frame"] == 2

        # the index page is served
        _, page = _get(viewer.url)
        assert b"frame.png" in page
    finally:
        viewer.stop()


def test_encode_png_roundtrip(tmp_path):
    rgb = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(rgb))
    back = read_png(str(p))
    assert back.shape == (5, 7, 3)
    np.testing.assert_allclose(back, rgb, atol=1.0 / 255.0)


def test_viewer_log_endpoint():
    """LogView analogue: /log serves the Server logger tail (same 50-entry
    cap as the reference's LogView/Logger contract)."""
    from nrenderer_tpu.server.registry import get_server
    logger = get_server().logger
    logger.clear()
    logger.warning("wavefront stalled")
    logger.success("pass 1 done")
    screen = Screen()
    viewer = ScreenViewer(screen, port=0).start()
    try:
        _, body = _get(viewer.url + "log")
        entries = json.loads(body)
        assert [e["type"] for e in entries[-2:]] == ["WARNING", "SUCCESS"]
        assert entries[-1]["content"] == "pass 1 done"
        assert all("timestamp" in e for e in entries)
        # the live pages poll it
        _, page = _get(viewer.url)
        assert b"/log" in page or b"'log'" in page
    finally:
        viewer.stop()
        logger.clear()
