"""Port parity, the live viewer: gsplat_tpu_torch's viewer.py and
network_gui.py against the JAX package's, and the viewer inside the port's
train() on the CPU.

- the SIBR wire format: parse_message field by field, the framing bytes of
  read_message/send_reply over a socket pair, camera_from_request's
  matrices bit-equal, image_to_bytes's bytes (truncation, no rounding) on
  values below 0, above 1 and at every half step of 1/255; on the host
  paths at 1x1 and 75x53 and with replies held at once;
- the servers: the browser page, preview.png (decodes to the rounded image
  handed to publish) and /metrics served, a port conflict soft; HTTP on the
  SIBR port, a first segment split in two, a connect-then-close probe, and
  a round trip against a mock trainer (as tests/test_network_gui.py);
- train() with the viewer on and a SIBR client: a reply equal to
  image_to_bytes of the port's render of the model the loop served it
  from, no step while the viewer pauses training, previews written, and
  the final parameters and PLY bit-equal to the same run with --quiet.

Servers bind ephemeral ports on 127.0.0.1.
"""

import json
import random
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import gsplat_tpu.network_gui as jgui
import gsplat_tpu_torch.train.loop as tloop
from gsplat_tpu_torch import config
from gsplat_tpu_torch import network_gui as tgui
from gsplat_tpu_torch.core.camera import make_camera
from gsplat_tpu_torch.interop import gaussians_to_numpy
from gsplat_tpu_torch.io import png
from gsplat_tpu_torch.io.synthetic import make_colmap_scene
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.viewer import ViewerServer

torch.set_num_threads(1)
R0, T0 = np.diag([1.0, -1.0, -1.0]), np.array([0.1, -0.2, 4.0])


def sibr_request(width, height, wv, fp, train=True, keep_alive=True, scaling_modifier=1.0):
    return {
        "resolution_x": width, "resolution_y": height, "train": train,
        "fov_y": 0.8, "fov_x": 1.2, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
        "view_matrix": [float(x) for x in np.asarray(wv).reshape(-1)],
        "view_projection_matrix": [float(x) for x in np.asarray(fp).reshape(-1)],
    }


def camera_request(width, height, **kw):
    cam = make_camera(R0, T0, fovx=1.2, fovy=0.8, width=width, height=height, device="cpu")
    return sibr_request(width, height, cam.world_view.numpy(), cam.full_proj.numpy(), **kw)


def send_msg(conn, msg):
    payload = json.dumps(msg).encode("utf-8")
    conn.sendall(struct.pack("<I", len(payload)) + payload)


def recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        assert part, "server closed early"
        buf += part
    return buf


def recv_reply(conn, width, height):
    img = recv_exact(conn, width * height * 3) if width else b""
    (vlen,) = struct.unpack("<I", recv_exact(conn, 4))
    return img, recv_exact(conn, vlen).decode("ascii")


def get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.headers.get("Content-Type"), r.read()


# ---------------------------------------------------------------- wire format


MESSAGES = {
    "full": dict(camera_request(16, 8), shs_python=True, rot_scale_python=True,
                 scaling_modifier=0.5, train=False),
    "handshake": {"resolution_x": 0, "resolution_y": 0, "train": True, "keep_alive": True},
    "defaults": {"resolution_x": 4, "resolution_y": 2,
                 "view_matrix": list(range(16)), "view_projection_matrix": [0.5] * 16},
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_parse_message_matches_jax(name):
    got, want = tgui.parse_message(MESSAGES[name]), jgui.parse_message(MESSAGES[name])
    for f in ("width", "height", "do_training", "keep_alive", "scaling_modifier", "fovx",
              "fovy", "shs_python", "rot_scale_python"):
        assert getattr(got, f) == getattr(want, f), f
        assert type(getattr(got, f)) is type(getattr(want, f)), f
    for f in ("world_view", "full_proj"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f


def _drain(sock, n):
    sock.settimeout(5)
    return recv_exact(sock, n)


@pytest.mark.parametrize("image", [None, b"", bytes(range(256)) * 3])
def test_framing_bytes_match_jax(image):
    got, want = [], []
    for mod, out in ((tgui, got), (jgui, want)):
        a, b = socket.socketpair()
        try:
            mod.send_reply(a, image, "/data/scene")
            out.append(_drain(b, (len(image) if image else 0) + 4 + len("/data/scene")))
            frame = struct.pack("<I", 7) + b'{"a":1}'
            b.sendall(frame[:3])
            b.sendall(frame[3:] + struct.pack("<I", 2) + b"[]")
            out.append(mod.read_message(a))
            out.append(mod.read_message(a))
        finally:
            a.close()
            b.close()
    assert got == want


def test_read_message_refuses_implausible_length():
    a, b = socket.socketpair()
    try:
        b.sendall(struct.pack("<I", (1 << 20) + 1))
        with pytest.raises(ConnectionError):
            tgui.read_message(a)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("size", [(16, 8), (37, 21)])
def test_camera_from_request_matches_jax(size):
    msg = camera_request(*size)
    got = tgui.camera_from_request(tgui.parse_message(msg), "cpu")
    want = jgui.camera_from_request(jgui.parse_message(msg))
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f
    assert (got.width, got.height, got.image, got.image_name, got.uid) == (
        want.width, want.height, want.image, want.image_name, want.uid)


def test_image_to_bytes_matches_jax():
    # every half step of 1/255 from -20 to 530 halves, and values far out
    steps = (np.arange(-20, 531) * (0.5 / 255)).astype(np.float32)
    img = np.concatenate([steps, np.array([-3.0, 7.0, np.nextafter(1, 0), 1.0],
                                          np.float32)]).reshape(-1, 5, 3)
    want = jgui.image_to_bytes(img)
    assert tgui.image_to_bytes(img) == want
    assert tgui.image_to_bytes(torch.from_numpy(img)) == want
    # truncation: 0.5/255 -> 0 and 1.5/255 -> 1, where the preview rounds to 1 and 2
    assert want[21] == 0 and want[23] == 1


@pytest.mark.parametrize("shape", [(1, 1), (53, 75), (4, 5)])
@pytest.mark.parametrize("layout", ["contiguous", "channels_first"])
def test_image_to_bytes_host_paths(shape, layout):
    """A host tensor (laid out either way) and a numpy array give the bytes
    of (clamp(x, 0, 1) * 255).to(uint8) in (H, W, 3) order."""
    x = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(
        -0.2, 1.2, (*shape, 3)).astype(np.float32))
    if layout == "channels_first":
        x = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        assert x.is_contiguous() == (shape == (1, 1))
    want = (torch.clamp(x, 0.0, 1.0) * 255).to(torch.uint8).contiguous().numpy().tobytes()
    assert tgui.image_to_bytes(x.numpy()) == want
    assert tgui.image_to_bytes(x) == want


def test_image_to_bytes_host_replies_held_at_once():
    """Three replies of three images, held together, each keep their own
    bytes after all three calls (the multi-viewer lifetime)."""
    imgs = [torch.full((6, 7, 3), v) for v in (0.1, 0.5, 0.9)]
    replies = [tgui.image_to_bytes(im) for im in imgs]
    for im, r in zip(imgs, replies):
        assert r == (im * 255).to(torch.uint8).numpy().tobytes()


# ---------------------------------------------------------------- servers


@pytest.mark.parametrize("server", ["viewer", "network_gui"])
def test_page_preview_png_and_metrics_served(tmp_path, server):
    (tmp_path / "metrics.jsonl").write_text(
        json.dumps({"step": 1, "loss": 0.5}) + "\n" + json.dumps({"step": 2, "loss": 0.25}) + "\n")
    srv = (ViewerServer(tmp_path, ip="127.0.0.1", port=0) if server == "viewer"
           else tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0))
    try:
        base = srv.url.rstrip("/")
        if server == "viewer":
            base = f"http://127.0.0.1:{srv._server.server_address[1]}"
        ctype, page = get(f"{base}/")
        assert ctype == "text/html" and b"gsplat-tpu" in page and b"/preview.png" in page
        with pytest.raises(urllib.error.HTTPError) as e:
            get(f"{base}/preview.png")
        assert e.value.code == 404
        img = np.random.default_rng(0).uniform(-0.2, 1.2, (16, 24, 3)).astype(np.float32)
        srv.publish(img)
        ctype, data = get(f"{base}/preview.png")
        assert ctype == "image/png"
        want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        assert np.array_equal(png.decode_png(data), want)
        assert not (tmp_path / ".preview.tmp.png").exists()
        _, rows = get(f"{base}/metrics")
        assert json.loads(rows)[-1]["loss"] == 0.25
    finally:
        srv.close()


def test_preview_from_a_tensor_equals_numpy(tmp_path):
    """The loop hands write_preview the render's tensor, rounded on its own
    device: the same bytes as the numpy path, and a stored PNG."""
    from gsplat_tpu_torch.viewer import write_preview

    img = np.random.default_rng(1).uniform(-0.2, 1.2, (21, 34, 3)).astype(np.float32)
    img[0, :3, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_preview(tmp_path / "a", img)
    write_preview(tmp_path / "b", torch.from_numpy(img))
    a, b = ((tmp_path / d / "preview.png").read_bytes() for d in ("a", "b"))
    assert a == b
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(png.decode_png(a), want)
    assert len(a) > want.size      # stored, not deflated


@pytest.mark.parametrize("server", ["viewer", "network_gui"])
def test_port_conflict_is_soft(tmp_path, server):
    s1 = tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0)
    try:
        s2 = (ViewerServer(tmp_path, ip="127.0.0.1", port=s1.port) if server == "viewer"
              else tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=s1.port))
        assert s2.url is None
        s2.publish(np.zeros((2, 2, 3)))   # a no-op
        assert not (tmp_path / "preview.png").exists()
        s2.close()
    finally:
        s1.close()


def test_protocol_roundtrip(tmp_path):
    srv = tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0, verify="/data/x")
    stop = threading.Event()

    def trainer():   # a mock trainer: a solid colour for every image request
        while not stop.is_set():
            req = srv.poll()
            if req is None:
                time.sleep(0.005)
                continue
            req.reply(b"\x10\x20\x30" * (req.width * req.height)
                      if req.world_view is not None else None)

    t = threading.Thread(target=trainer, daemon=True)
    t.start()
    try:
        conn = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        send_msg(conn, camera_request(8, 4))
        assert recv_reply(conn, 8, 4) == (b"\x10\x20\x30" * 32, "/data/x")
        send_msg(conn, MESSAGES["handshake"])
        assert recv_reply(conn, 0, 0) == (b"", "/data/x")
        send_msg(conn, camera_request(2, 2, keep_alive=False))
        recv_reply(conn, 2, 2)
        time.sleep(0.1)
        assert conn.recv(1) == b""   # keep_alive False: an orderly close
        conn.close()
    finally:
        stop.set()
        t.join(timeout=5)
        srv.close()
    assert not t.is_alive()


def test_gui_request_span_counts_the_queue_wait(tmp_path):
    """A request the server queues carries its receipt time; under a
    profiler the loop's serve is a root span, gui.request, over the
    request's camera, render and bytes, that counts the request's wait in
    the queue (queue_ms)."""
    import torch_port_fixtures as F
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch import spans

    g, _ = F.torch_objects(F.make_scene())
    mesh = config.MeshParams(tile_size=16, chunk_size=32)
    srv = tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0, verify="v")
    try:
        conn = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        send_msg(conn, camera_request(24, 20))
        req, deadline = None, time.time() + 10
        while req is None and time.time() < deadline:
            req = srv.poll()
            time.sleep(0.005)
        assert req is not None and req.received_ns > 0
        time.sleep(0.05)
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            tloop._serve_gui_request(srv, req, g, torch.zeros(3), mesh, 2048)
        img, verify = recv_reply(conn, 24, 20)
        conn.close()
    finally:
        srv.close()
    assert len(img) == 24 * 20 * 3 and verify == "v" and srv.render_errors == 0
    recs = spans.records()
    (root,) = [r for r in recs if r.name == "gui.request"]
    assert root.parent is None and root.counters["queue_ms"] >= 50.0
    names = {r.name for r in recs if r.root == root.id}
    assert {"gui.request", "gui.camera", "render", "gather", "gui.to_bytes",
            "gui.to_bytes.copy"} <= names
    assert all(r.root == root.id for r in recs)


def test_http_on_sibr_port_split_segment_and_probe(tmp_path):
    """HTTP on the SIBR port; a 2-byte first TCP segment must not pass for
    SIBR; a connect-then-close probe must not stop the server."""
    (tmp_path / "metrics.jsonl").write_text("{}\n")
    srv = tgui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0)
    try:
        for _ in range(3):
            socket.create_connection(("127.0.0.1", srv.port), timeout=5).close()
        time.sleep(0.1)
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        c.sendall(b"GE")
        time.sleep(0.1)
        c.sendall(b"T / HTTP/1.1\r\nHost: x\r\n\r\n")
        resp = b""
        while b"\r\n\r\n" not in resp:
            part = c.recv(4096)
            if not part:
                break
            resp += part
        c.close()
        assert resp.startswith(b"HTTP/1.0 200"), resp[:40]
        _, page = get(f"{srv.url}")
        assert b"gsplat-tpu" in page
    finally:
        srv.close()


# ---------------------------------------------------------------- train()


ITERS, PORT_WAIT = 40, 30.0
OPT = dict(random_background=True, densify_from_iter=2, densification_interval=10,
           densify_until_iter=35, opacity_reset_interval=25)


def _train(scene, out, quiet, port=0, progress_every=100):
    model = config.ModelParams(source_path=str(scene), model_path=str(out), data_device="cpu")
    other = config.OtherParams(test_iterations=[], save_iterations=[ITERS], quiet=quiet,
                               ip="127.0.0.1", port=port)
    mesh = config.MeshParams(capacity=64, pair_budget=2048, chunk_size=32, tile_size=16)
    random.seed(0)
    np.random.seed(0)
    return tloop.train(model, config.OptimizationParams(iterations=ITERS, **OPT),
                       config.PipelineParams(), other, mesh, progress_every=progress_every)


@pytest.fixture(scope="module")
def viewer_runs(tmp_path_factory):
    """The same train() with --quiet and with the viewer on, a SIBR client
    rendering, pausing and resuming -> (quiet run, viewer run, what the
    client and the loop saw)."""
    root = tmp_path_factory.mktemp("viewer")
    scene = make_colmap_scene(root / "scene", n_cams=4, width=40, height=32, n_points=40)
    quiet = _train(scene, root / "quiet", quiet=True)

    seen = dict(steps=0, served=[], replies=[], paused_steps=[], errors=[])
    real_step, real_serve, real_server = (tloop.make_train_step, tloop._serve_gui_request,
                                          tloop.NetworkGUIServer)
    bound, connected = threading.Event(), threading.Event()

    def make_train_step(*a, **kw):
        step = real_step(*a, **kw)

        def counted(*sa, **skw):
            seen["steps"] += 1
            return step(*sa, **skw)
        return counted

    def serve(viewer, req, g, bg, mesh, pair_budget):
        seen["served"].append(dict(req=req, iteration=seen["steps"] + 1, pair_budget=pair_budget,
                                   bg=bg.clone(), g=g.replace(**{
                                       k: v.clone() for k, v in vars(g).items()
                                       if isinstance(v, torch.Tensor)})))
        real_serve(viewer, req, g, bg, mesh, pair_budget)

    class Server(real_server):
        """Holds train() until the client has connected, so that the
        client's requests land inside the run whatever the host's speed."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)     # on an ephemeral port (--port 0)
            seen["server"] = self
            bound.set()
            connected.wait(PORT_WAIT)

    def client():
        try:
            assert bound.wait(PORT_WAIT), "train() started no viewer"
            conn = socket.create_connection(("127.0.0.1", seen["server"].port), timeout=10)
            conn.settimeout(60)
            send_msg(conn, camera_request(24, 20, scaling_modifier=0.8))
            connected.set()
            seen["replies"].append(recv_reply(conn, 24, 20))
            send_msg(conn, camera_request(24, 20, train=False))
            seen["replies"].append(recv_reply(conn, 24, 20))
            seen["paused_steps"].append(seen["steps"])
            time.sleep(0.3)
            send_msg(conn, camera_request(40, 32, train=False))
            seen["replies"].append(recv_reply(conn, 40, 32))
            seen["paused_steps"].append(seen["steps"])
            send_msg(conn, dict(camera_request(8, 8), keep_alive=False))
            seen["replies"].append(recv_reply(conn, 8, 8))
            conn.close()
        except Exception as e:  # reported by the tests
            seen["errors"].append(repr(e))
        finally:
            connected.set()

    t = threading.Thread(target=client, daemon=True)
    tloop.make_train_step, tloop._serve_gui_request, tloop.NetworkGUIServer = (
        make_train_step, serve, Server)
    try:
        t.start()
        viewer = _train(scene, root / "viewer", quiet=False, port=0, progress_every=10)
    finally:
        tloop.make_train_step, tloop._serve_gui_request, tloop.NetworkGUIServer = (
            real_step, real_serve, real_server)
        t.join(timeout=PORT_WAIT)
    seen["client_alive"] = t.is_alive()
    return root, quiet, viewer, seen


def test_viewer_replies_equal_the_render(viewer_runs):
    root, _, _, seen = viewer_runs
    assert not seen["errors"] and not seen["client_alive"], seen["errors"]
    assert seen["server"].render_errors == 0
    assert len(seen["served"]) == len(seen["replies"]) == 4
    for s, (img, verify) in zip(seen["served"], seen["replies"]):
        req = s["req"]
        cam = tgui.camera_from_request(req, "cpu")
        out = render(cam, s["g"], s["bg"], tile_size=16, chunk=32, pair_budget=s["pair_budget"],
                     scaling_modifier=req.scaling_modifier)
        assert int(out.n_dropped) == 0
        assert img == tgui.image_to_bytes(out.image), (req.width, req.height)
        assert verify == str(root / "scene")
    assert seen["served"][0]["iteration"] > 0 and seen["served"][0]["req"].scaling_modifier == 0.8


def test_viewer_pause_holds_the_steps(viewer_runs):
    _, _, _, seen = viewer_runs
    a, b = seen["paused_steps"]
    assert a == b < ITERS
    assert seen["steps"] == ITERS


def test_viewer_writes_previews(viewer_runs):
    root, _, viewer, _ = viewer_runs
    g, scene = viewer
    data = (root / "viewer" / "preview.png").read_bytes()
    cam = scene.get_train_cameras()[0]
    assert png.decode_png(data).shape == (cam.height, cam.width, 3)
    assert not (root / "quiet" / "preview.png").exists()


def test_viewer_run_bit_equal_to_quiet(viewer_runs):
    root, quiet, viewer, _ = viewer_runs
    a, b = gaussians_to_numpy(quiet[0]), gaussians_to_numpy(viewer[0])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ply = f"point_cloud/iteration_{ITERS}/point_cloud.ply"
    assert (root / "quiet" / ply).read_bytes() == (root / "viewer" / ply).read_bytes()
