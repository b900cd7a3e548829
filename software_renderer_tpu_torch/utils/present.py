"""Live present surface: an HTTP viewer for the frame loop.

Counterpart of the JAX package's utils/present.py. A render host is
headless, so the "screen" is a browser tab: :class:`PresentServer` holds
the latest encoded frame and serves

  /            a viewer page that repaints at the display refresh rate
               (requestAnimationFrame) and shows the render and present
               FPS counters,
  /frame.png   the most recent frame (no-cache),
  /stats.json  {"frame": n, "fps": render-side FPS}.

Everything is stdlib (``http.server`` and the in-memory PNG encoder of
utils/image_io.py). :meth:`PresentServer.present` converts a frame to
RGBA8 on the frame's device, copies it to the host once and encodes it;
the server thread only ever touches the encoded bytes, never a tensor,
so a slow viewer drops frames instead of holding the render loop back.

Usage::

    loop = FrameLoop(scene_fn, transform_fn)
    with PresentServer() as srv:        # prints the URL
        loop.run(600, present=srv)
"""

from __future__ import annotations

import json
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..framebuffer import to_rgba8
from .image_io import encode_png
from .log import get_logger

log = get_logger("present")

_PAGE = b"""<!doctype html>
<html><head><title>software-renderer-tpu-torch</title><style>
 body { background:#111; color:#ddd; font:13px monospace; margin:16px }
 img { image-rendering:pixelated; border:1px solid #333; max-width:100% }
</style></head><body>
<div id=s>connecting...</div><p><img id=v></p>
<script>
const v = document.getElementById('v'), s = document.getElementById('s');
let shown = 0, t0 = performance.now(), last = -1;
async function stats() {
  try {
    const r = await (await fetch('stats.json')).json();
    if (r.frame !== last) {
      last = r.frame;
      v.src = 'frame.png?' + r.frame;   // cache-bust per new frame only
      shown++;
    }
    const pfps = shown / ((performance.now() - t0) / 1000);
    s.textContent = 'frame ' + r.frame + ' | render ' +
      r.fps.toFixed(1) + ' FPS | present ' + pfps.toFixed(1) + ' FPS';
  } catch (e) { s.textContent = 'stream ended'; return; }
  requestAnimationFrame(stats);
}
stats();
</script></body></html>
"""


def _rgba8_of(color) -> torch.Tensor:
    """A frame ([H, W, 4] float, or uint8 already) as uint8 RGBA on the
    frame's device (a numpy frame becomes a CPU tensor)."""
    color = torch.as_tensor(color)
    return color if color.dtype == torch.uint8 else to_rgba8(color)


class PresentServer:
    """Serves the latest rendered frame over HTTP.

    Thread-safe: :meth:`present` may be called from the frame loop while
    any number of viewer requests are in flight. Holding only the newest
    frame (not a queue) is deliberate: present never blocks rendering.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 png_level: int = 1):
        self._lock = threading.Lock()
        self._png = encode_png(np.zeros((2, 2, 4), np.uint8))
        self._frame = -1
        self._fps = 0.0
        self._t_last = None
        self._png_level = png_level  # speed over size: a localhost wire
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                log.debug("http: " + fmt, *args)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/" or path == "/index.html":
                    self._reply(200, "text/html", _PAGE)
                elif path == "/frame.png":
                    with server._lock:
                        body = server._png
                    self._reply(200, "image/png", body)
                elif path == "/stats.json":
                    with server._lock:
                        body = json.dumps({"frame": server._frame,
                                           "fps": server._fps}).encode()
                    self._reply(200, "application/json", body)
                else:
                    self._reply(404, "text/plain", b"not found")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # viewer navigated away mid-frame

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "PresentServer":
        self._thread.start()
        log.info("present surface live at %s", self.url)
        print(f"[present] viewer: {self.url}", flush=True)
        return self

    def present(self, color) -> None:
        """Publish a frame: [H, W, 4] float (a framebuffer's color) or
        uint8, a tensor on any device or a numpy array.

        FrameLoop.run(present=...) calls it with the PREVIOUS frame, already
        RGBA8 in host memory, so encoding overlaps the device rendering
        the next frame (utils/display.py).
        """
        png = encode_png(_rgba8_of(color), level=self._png_level)
        now = _time.perf_counter()
        with self._lock:
            if self._t_last is not None:
                dt = now - self._t_last
                inst = 1.0 / dt if dt > 0 else 0.0
                # EMA so the counter is readable, not jittery.
                self._fps = inst if self._fps == 0.0 else (
                    0.9 * self._fps + 0.1 * inst)
            self._t_last = now
            self._frame += 1
            self._png = png

    def stop(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()

    def __enter__(self) -> "PresentServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
