"""Minimal live render viewer: the headless analogue of the reference's
ScreenView (`code/app/src/ui/views/ScreenView.cpp:98-178`),
which polls `Screen::isUpdated()` every UI frame and blits the buffer into a
GL texture.  Here a tiny stdlib HTTP server does the same over the network:

  - `GET /`          a self-refreshing HTML page (JS polls /status and
                     reloads /frame.png only when the frame counter moved)
  - `GET /frame.png` the latest Screen buffer, PNG-encoded
  - `GET /status`    JSON: frame counter, dimensions, manager state

The renderer thread posts progressive previews to the Server's `Screen`
(`--progressive` passes, chunked AccPT, MLT blocks); this viewer CONSUMES
`is_updated` exactly like the reference's UI loop and keeps its own
monotonic frame counter so any number of browser tabs can poll without
stealing each other's dirty flag.

Usage (CLI): `render ... --serve [PORT]` — the URL is printed at start;
the server stays up until the process exits.  API: `ScreenViewer(screen);
v.start(); ...; v.stop()`.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>nrenderer-tpu live view</title><style>
body { background: #181818; color: #ccc; font-family: monospace;
       display: flex; flex-direction: column; align-items: center; }
img { image-rendering: pixelated; border: 1px solid #444;
      max-width: 95vw; max-height: 85vh; }
</style></head><body>
<h3 id="st">waiting for first frame...</h3>
<img id="frame" alt="(no frame posted yet)"/>
<pre id="log" style="font-size:11px;color:#897;max-height:12vh;
     overflow:auto;width:90vw"></pre>
<script>
let last = -1;
async function tick() {
  try {
    const r = await fetch('/status');
    const s = await r.json();
    document.getElementById('st').textContent =
      `${s.width}x${s.height}  frame ${s.frame}  state ${s.state}`;
    if (s.frame !== last && s.frame > 0) {
      last = s.frame;
      document.getElementById('frame').src = '/frame.png?f=' + s.frame;
    }
    const lg = await (await fetch('/log')).json();
    document.getElementById('log').textContent =
      lg.map(m => `[${m.type}] ${m.content}`).join('\\n');
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class ScreenViewer:
    """Serves a `Screen`'s progressive frames over HTTP (see module doc)."""

    def __init__(self, screen, port: int = 0,
                 state_fn: Optional[Callable[[], str]] = None,
                 routes: Optional[dict] = None):
        self._screen = screen
        self._state_fn = state_fn or (lambda: "-")
        # custom routes take precedence over the built-ins: a handler is
        # `fn(method, body) -> (code, content_type, bytes)` — used by the
        # scene editor (`server/editor.py`) to replace `/` and add /scene
        self._routes = dict(routes or {})
        self._frame = 0
        self._png: Optional[bytes] = None
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                          self._make_handler())
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://localhost:{self.port}/"

    def start(self) -> "ScreenViewer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- frame capture -------------------------------------------------------

    def _poll(self):
        """Consume the Screen's dirty flag (the reference UI's
        `isUpdated()` -> `getPixels()` sequence, ScreenView.cpp:168-178)
        and re-encode at most once per new frame."""
        if self._screen.is_updated:
            px = self._screen.get_pixels()
            if px is not None:
                from ..io.image import encode_png
                png = encode_png(np.asarray(px))
                with self._lock:
                    self._png = png
                    self._frame += 1
        with self._lock:
            return self._frame, self._png

    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _dispatch_custom(self, method):
                path = self.path.split("?")[0]
                route = viewer._routes.get(path)
                if route is None:
                    return False
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                try:
                    code, ctype, payload = route(method, body)
                except Exception as exc:  # keep the connection protocol-clean
                    code, ctype = 500, "text/plain"
                    payload = f"internal error: {exc!r}".encode()
                self._send(code, ctype, payload)
                return True

            def do_POST(self):
                if not self._dispatch_custom("POST"):
                    self._send(404, "text/plain", b"not found")

            def do_GET(self):
                if self._dispatch_custom("GET"):
                    return
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/status":
                    frame, _ = viewer._poll()
                    body = json.dumps({
                        "frame": frame,
                        "width": viewer._screen.width,
                        "height": viewer._screen.height,
                        "state": viewer._state_fn(),
                    }).encode()
                    self._send(200, "application/json", body)
                elif path == "/log":
                    # LogView analogue (reference LogView.cpp renders the
                    # Logger tail every UI frame); same 50-entry cap
                    from .registry import get_server
                    body = json.dumps([
                        {"type": m.type.name, "content": m.content,
                         "timestamp": m.timestamp}
                        for m in get_server().logger.get()
                    ]).encode()
                    self._send(200, "application/json", body)
                elif path == "/frame.png":
                    frame, png = viewer._poll()
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler
