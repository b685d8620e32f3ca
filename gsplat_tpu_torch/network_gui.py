"""Upstream-compatible network GUI endpoint on the reference's ip/port flags.

The port's copy of gsplat_tpu/network_gui.py. Upstream 3DGS binds --ip and
--port to the SIBR remote viewer's TCP protocol
(`gaussian_renderer/network_gui.py` in the public INRIA trainer): the
trainer LISTENS, the viewer connects and, per round trip, sends

    [u32-LE length][JSON payload]

with keys resolution_x/resolution_y, train, fov_y, fov_x, z_near, z_far,
shs_python, rot_scale_python, keep_alive, scaling_modifier, view_matrix (16
floats, row-vector/transposed convention) and view_projection_matrix (16
floats); the trainer replies

    [H*W*3 raw uint8 RGB bytes (only when resolution_x > 0)]
    [u32-LE length][verify string (the model path)]

The accept loop sniffs each connection's first bytes: an HTTP verb hands the
socket to the HTTP preview handler (viewer.ViewerServer's page), anything
else speaks the SIBR protocol. One port, both clients.

Threading: sockets are owned by daemon threads, which never touch torch;
the TRAINING thread does every render. A connection thread parses one
request, parks it in `pending` and blocks on its reply slot; the loop calls
`poll()` every iteration, renders the requested view and `reply()` unblocks
the connection thread. While the viewer has paused training (train=False)
the loop keeps polling: see train.loop. `render_errors` counts the GUI
renders that raised (the loop replies without an image and trains on).

Where the port differs: `camera_from_request` builds the port's Camera on a
given device; `image_to_bytes` also takes a torch tensor, which it
quantises on its own device before one copy of the bytes to the host (the
same float32 arithmetic as the numpy path, so the same bytes), returned as
a memoryview. Under a profiler the three are spans of
gsplat_tpu_torch.spans ("gui.parse", "gui.camera", "gui.to_bytes" with its
"gui.to_bytes.quantize" and "gui.to_bytes.copy"), and a queued request
carries its receipt time (`received_ns`) for the loop's "gui.request".
"""


from __future__ import annotations

import json
import math
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch import spans
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.viewer import _Handler, write_preview

_HTTP_VERBS = (b"GET ", b"POST", b"HEAD", b"PUT ", b"OPTI", b"DELE")


@dataclass
class GuiRequest:
    """One parsed viewer round-trip, owned by a connection thread."""
    width: int
    height: int
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    world_view: Optional[np.ndarray]      # (4,4) f32, row-vector convention
    full_proj: Optional[np.ndarray]       # (4,4) f32
    fovx: float
    fovy: float
    shs_python: bool = False
    rot_scale_python: bool = False
    received_ns: int = 0                  # perf_counter_ns when queued; 0 if never
    _done: threading.Event = field(default_factory=threading.Event)
    _image: Optional[bytes] = None

    def reply(self, image: Optional[bytes]) -> None:
        self._image = image
        self._done.set()


def parse_message(msg: dict) -> GuiRequest:
    # a root span: connection threads parse while the training thread runs
    with spans.span("gui.parse", root=True):
        w, h = int(msg["resolution_x"]), int(msg["resolution_y"])
        wv = fp = None
        if w > 0 and h > 0:
            wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
            fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        return GuiRequest(
            width=w, height=h,
            do_training=bool(msg.get("train", True)),
            keep_alive=bool(msg.get("keep_alive", True)),
            scaling_modifier=float(msg.get("scaling_modifier", 1.0)),
            world_view=wv, full_proj=fp,
            fovx=float(msg.get("fov_x", 1.0)), fovy=float(msg.get("fov_y", 1.0)),
            shs_python=bool(msg.get("shs_python", False)),
            rot_scale_python=bool(msg.get("rot_scale_python", False)),
        )


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return buf


def read_message(conn: socket.socket) -> dict:
    (length,) = struct.unpack("<I", _recv_exact(conn, 4))
    if length > 1 << 20:
        raise ConnectionError(f"implausible message length {length}")
    return json.loads(_recv_exact(conn, length).decode("utf-8"))


def send_reply(conn: socket.socket, image: Optional[bytes], verify: str) -> None:
    if image:
        conn.sendall(image)
    v = verify.encode("ascii")
    conn.sendall(struct.pack("<I", len(v)) + v)


class NetworkGUIServer:
    """Dual-protocol (SIBR wire format + HTTP preview) server for training."""

    def __init__(self, model_dir, ip: str = "127.0.0.1", port: int = 6009,
                 verify: str = ""):
        self.model_dir = model_dir
        self.verify = verify or str(model_dir)
        self._pending: list[GuiRequest] = []
        self._lock = threading.Lock()
        self._sibr_alive = 0  # live SIBR connections (pause ends when 0)
        self._sock: Optional[socket.socket] = None
        self._http_handler = type("_H", (_Handler,), {"model_dir": model_dir})
        self.training_paused = False
        self.render_errors = 0
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((ip, port))
            s.listen(8)
            self._sock = s
            self.port = s.getsockname()[1]
            self.url = f"http://{ip}:{self.port}/"
            threading.Thread(target=self._accept_loop, daemon=True).start()
        except OSError as e:  # best-effort, like the HTTP viewer
            self.url = None
            self._err = str(e)

    # -- socket side (daemon threads) --------------------------------------

    def _accept_loop(self) -> None:
        while self._sock is not None:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn, addr), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        try:
            # a short first TCP segment must not misclassify the protocol:
            # peek until 4 bytes are buffered (or the peer closed)
            head = b""
            while len(head) < 4:
                head = conn.recv(4, socket.MSG_PEEK)
                if not head:
                    return
                if len(head) < 4:
                    time.sleep(0.005)
            if head[:4] in _HTTP_VERBS or head[:3] == b"GET":
                # hand the raw socket to the HTTP preview handler
                self._http_handler(conn, addr, None)
                return
            with self._lock:
                self._sibr_alive += 1
            try:
                while True:
                    req = parse_message(read_message(conn))
                    req.received_ns = time.perf_counter_ns()
                    with self._lock:
                        self._pending.append(req)
                    if not req._done.wait(timeout=600.0):
                        return
                    send_reply(conn, req._image, self.verify)
                    if not req.keep_alive:
                        return
            finally:
                with self._lock:
                    self._sibr_alive -= 1
        except (ConnectionError, OSError, ValueError, json.JSONDecodeError,
                KeyError, TypeError, IndexError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- trainer side (training thread) -------------------------------------

    def poll(self) -> Optional[GuiRequest]:
        """Next pending viewer request, or None. The caller must .reply()."""
        with self._lock:
            return self._pending.pop(0) if self._pending else None

    @property
    def sibr_connected(self) -> bool:
        with self._lock:
            return self._sibr_alive > 0

    def publish(self, image: Union[np.ndarray, torch.Tensor]) -> None:
        """Browser-preview path (same contract as viewer.ViewerServer)."""
        if self._sock is None:
            return
        write_preview(self.model_dir, image)

    def close(self) -> None:
        if self._sock is not None:
            s, self._sock = self._sock, None
            try:
                s.close()
            except OSError:
                pass


def camera_from_request(req: GuiRequest, device: Union[str, torch.device]) -> Camera:
    """Build a render-ready Camera on `device` from the viewer's matrices (no
    GT image): cam_center = inv(world_view)[3, :3] and tan(fov / 2) in
    float32 numpy, as the JAX package computes them."""
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    with spans.span("gui.camera"):
        wv = np.asarray(req.world_view, np.float32)
        cam_center = np.linalg.inv(wv)[3, :3]
        return Camera(
            world_view=f32(wv),
            full_proj=f32(req.full_proj),
            cam_center=f32(cam_center),
            tan_fovx=f32(math.tan(req.fovx * 0.5)),
            tan_fovy=f32(math.tan(req.fovy * 0.5)),
            image=None,
            width=req.width,
            height=req.height,
            image_name="network_gui",
            uid=-1,
        )


def image_to_bytes(image: Union[np.ndarray, torch.Tensor]) -> Union[bytes, memoryview]:
    """(H,W,3) float [0,1] -> raw uint8 RGB bytes (upstream's memoryview):
    clip, times 255, truncated (no rounding, unlike the preview and the
    render CLI's PNGs). A tensor comes back as a flat memoryview of its one
    host copy (sendall takes it as it is: a 1080p frame's 6.2 MB are not
    copied again)."""
    with spans.span("gui.to_bytes"):
        if isinstance(image, torch.Tensor):
            with spans.span("gui.to_bytes.quantize"):
                q = (torch.clamp(image.detach(), 0.0, 1.0) * 255).to(torch.uint8)
            with spans.span("gui.to_bytes.copy"):
                return memoryview(q.cpu().numpy().reshape(-1))
        arr = (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
        return arr.tobytes()
