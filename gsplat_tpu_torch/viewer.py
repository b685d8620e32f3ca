"""Live training viewer: a minimal HTTP server on the reference's ip/port flags.

The port's copy of gsplat_tpu/viewer.py. It serves the latest training
render and the metrics stream to any browser at http://<ip>:<port>/. The
trainer publishes a preview image into the model directory; the server (a
daemon thread) serves files: no state shared with the training loop, no
locking against it.

The one difference: the preview is a PNG (`preview.png`, served as
`image/png`; the page points at it), written through io/png.py, where the
JAX module writes a PIL JPEG at quality 88 (the machine with the GPU has no
Pillow, and the port no JPEG encoder). The loop publishes every
`progress_every` iterations of every run without --quiet, so the encode
sits on the default training path: the PNG is stored (zlib level 0, no row
filter), which costs about a copy of the image. A render of a 1M-Gaussian
scene is noise at the pixel scale: deflate at level 1 shrinks such a 1080p
frame by about a quarter for more than ten times the time.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch.io import png

# the preview PNG's zlib level and row filter (see the module docstring)
PREVIEW_LEVEL, PREVIEW_FILTER = 0, png.NONE

_PAGE = """<!doctype html>
<html><head><title>gsplat-tpu viewer</title>
<style>
 body {{ font-family: monospace; background: #111; color: #ddd; margin: 2em; }}
 img {{ image-rendering: pixelated; max-width: 90vw; border: 1px solid #444; }}
 table {{ border-collapse: collapse; margin-top: 1em; }}
 td, th {{ border: 1px solid #333; padding: 2px 10px; text-align: right; }}
</style></head>
<body>
<h2>gsplat-tpu — live training</h2>
<img id="im" src="/preview.png" onerror="this.alt='waiting for first preview...'">
<div id="meta"></div>
<table id="tbl"></table>
<script>
 setInterval(() => {{
   document.getElementById('im').src = '/preview.png?' + Date.now();
   fetch('/metrics').then(r => r.json()).then(rows => {{
     if (!rows.length) return;
     const keys = Object.keys(rows[rows.length-1]);
     let h = '<tr>' + keys.map(k => '<th>'+k+'</th>').join('') + '</tr>';
     for (const row of rows.slice(-12).reverse())
       h += '<tr>' + keys.map(k => '<td>'+(row[k] !== undefined ? (typeof row[k]==='number'? row[k].toPrecision(5): row[k]) : '')+'</td>').join('') + '</tr>';
     document.getElementById('tbl').innerHTML = h;
   }});
 }}, 2000);
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    model_dir: Path = Path(".")

    def log_message(self, *args):  # silence request logging
        pass

    def _send(self, code, ctype, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?")[0]
        try:
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/preview.png":
                p = self.model_dir / "preview.png"
                if p.exists():
                    self._send(200, "image/png", p.read_bytes())
                else:
                    self._send(404, "text/plain", b"no preview yet")
            elif path == "/metrics":
                p = self.model_dir / "metrics.jsonl"
                rows = []
                if p.exists():
                    lines = p.read_text().strip().splitlines()[-50:]
                    rows = [json.loads(l) for l in lines if l.strip()]
                self._send(200, "application/json", json.dumps(rows).encode())
            else:
                self._send(404, "text/plain", b"not found")
        except (BrokenPipeError, ConnectionResetError):
            pass


def write_preview(model_dir, image: Union[np.ndarray, torch.Tensor]) -> None:
    """Atomic preview.png write shared by the HTTP viewer and the network GUI
    (clip to [0,1], round, tmp-then-replace so readers never see a torn file).
    A tensor is rounded on its own device (the same float32 arithmetic) and
    copied to the host as 8 bits.
    """
    if isinstance(image, torch.Tensor):
        arr = (torch.clamp(image.detach(), 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
    else:
        arr = (np.clip(np.asarray(image), 0, 1) * 255 + 0.5).astype(np.uint8)
    tmp = Path(model_dir) / ".preview.tmp.png"
    tmp.write_bytes(png.encode_png(arr, PREVIEW_FILTER, PREVIEW_LEVEL))
    tmp.replace(Path(model_dir) / "preview.png")


class ViewerServer:
    """Serves http://<ip>:<port>/ for a model directory; publish() posts frames."""

    def __init__(self, model_dir: str | Path, ip: str = "127.0.0.1",
                 port: int = 6009):
        self.model_dir = Path(model_dir)
        self._server: Optional[ThreadingHTTPServer] = None
        try:
            handler = type("_H", (_Handler,), {"model_dir": self.model_dir})
            self._server = ThreadingHTTPServer((ip, port), handler)
            t = threading.Thread(target=self._server.serve_forever, daemon=True)
            t.start()
            self.url = f"http://{ip}:{port}/"
        except OSError as e:  # port in use etc. — viewer is best-effort
            self.url = None
            self._err = str(e)

    def publish(self, image: Union[np.ndarray, torch.Tensor]) -> None:
        """image: (H,W,3) float in [0,1]; written atomically as preview.png."""
        if self._server is None:
            return
        write_preview(self.model_dir, image)

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
