"""PyTorch port, serving: the port's frame decode, batcher, streaming
counters and ``WorkoutServer`` against the JAX package's on the same
inputs and the same numpy-seeded flax weights (CPU).

Two servers run side by side on free localhost ports, each over TSM-R18
at 32 px in fp32 with 11 classes (the JAX one through XLA, the port's on
its kernels' plain versions). Bounds:

- ``decode_data_url``, ``prep_frames``: bit-identical arrays;
  ``scores_to_payload``: identical;
- ``OnlineRepCounter``: identical counts and reps to the JAX counter and
  to ``pred_to_count`` on every generated sequence;
- POST /video (raw and multipart) and WebSocket replies: the same label
  order and the same count-mode states and counts; scores within 1e-4
  (the torch↔JAX bar of the model tests);
- /healthz and /stats: the same keys; drain, path traversal and the
  count-periodic refusal: the same answers.
"""

import asyncio
import base64
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_tsm import randomized_variables
from workoutdetector_tpu.counting import pred_to_count as jpred_to_count
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import streaming as jstreaming
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.serve import server as jserver
from workoutdetector_tpu_torch.counting import pred_to_count
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.infer import streaming
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.serve import AsyncBatcher
from workoutdetector_tpu_torch.serve import server as tserver

SIZE = 32
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _frames(n, seed, h=60, w=80):
    """n RGB frames whose brightness walks, with noise."""
    rng = np.random.default_rng(seed)
    base = np.linspace(20, 235, n)[:, None, None, None]
    noise = rng.integers(-15, 16, (n, h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _data_url(frame, fmt="WEBP"):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format=fmt)
    mime = {"WEBP": "webp", "PNG": "png", "JPEG": "jpeg"}[fmt]
    return f"data:image/{mime};base64," + base64.b64encode(
        buf.getvalue()).decode()


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("fmt", ["WEBP", "PNG", "JPEG"])
def test_decode_data_url_matches_jax(fmt):
    url = _data_url(_frames(1, 0)[0], fmt)
    got, want = tserver.decode_data_url(url), jserver.decode_data_url(url)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for bad in ("stop", "data:image/webp;base64,AAAA"):
        assert tserver.decode_data_url(bad) is None
        assert jserver.decode_data_url(bad) is None


def test_decode_image_bytes_cv2_without_pil(monkeypatch):
    """Without PIL a non-JPEG frame decodes with cv2.imdecode, to the same
    pixels as PIL for a lossless PNG."""
    import builtins
    frame = _frames(1, 1)[0]
    raw = base64.b64decode(_data_url(frame, "PNG").split(",", 1)[1])
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img, backend = tserver.decode_image_bytes(raw)
    assert backend == "cv2"
    np.testing.assert_array_equal(img, frame)


def test_prep_frames_and_payload_match_jax():
    frames = list(_frames(8, 2, h=240, w=320))
    got, want = tserver.prep_frames(frames, SIZE), jserver.prep_frames(
        frames, SIZE)
    assert got.shape == (8, SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)
    scores = np.random.default_rng(3).standard_normal(13).astype(np.float32)
    labels = tserver.WORKOUT_LABELS
    assert labels == jserver.WORKOUT_LABELS
    got, want = tserver.scores_to_payload(scores, labels), \
        jserver.scores_to_payload(scores, labels)
    assert list(got.items()) == list(want.items())


# ---------------------------------------------------------------- batcher


def test_async_batcher_coalesces():
    calls = []

    def score_fn(arr):
        calls.append(arr.shape[0])
        return np.tile(np.arange(3, dtype=np.float32), (arr.shape[0], 1))

    async def drive():
        b = AsyncBatcher(score_fn, max_batch=8, max_delay_ms=50)
        outs = await asyncio.gather(*[
            b.score(np.zeros((2, 4, 4, 3), np.uint8)) for _ in range(6)])
        await b.stop()
        return outs

    outs = asyncio.run(drive())
    assert len(outs) == 6 and all(o.shape == (3,) for o in outs)
    assert sum(calls) == 6 and len(calls) <= 3


def test_async_batcher_rolling_deadline():
    """A wave of arrivals 30 ms apart (each gap inside the 50 ms quiet
    window) coalesces into one flush; a later request alone is its own."""
    calls = []

    def score_fn(arr):
        calls.append(arr.shape[0])
        return np.tile(np.arange(2, dtype=np.float32), (arr.shape[0], 1))

    batcher = AsyncBatcher(score_fn, max_batch=16, max_delay_ms=50,
                           stretch=6.0)

    async def drive():
        async def one(delay_s):
            await asyncio.sleep(delay_s)
            return await batcher.score(np.zeros((2, 2, 3), np.uint8))

        assert len(await asyncio.gather(*[one(0.03 * i)
                                          for i in range(5)])) == 5
        await asyncio.sleep(0.15)
        await batcher.score(np.zeros((2, 2, 3), np.uint8))
        await batcher.stop()

    asyncio.run(drive())
    # one split tolerated where a loaded machine stalls the loop
    assert sum(calls[:-1]) == 5 and len(calls) <= 3, calls
    assert calls[0] >= 3 and calls[-1] == 1, calls


# ---------------------------------------------------------------- streaming


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(-1, 5), min_size=1, max_size=40))
def test_online_counter_matches_jax_and_pred_to_count(preds):
    ours, theirs = streaming.OnlineRepCounter(8), jstreaming.OnlineRepCounter(8)
    flags = [ours.push_state(p) for p in preds]
    assert flags == [theirs.push_state(p) for p in preds]
    assert (ours.count, ours.reps) == (theirs.count, theirs.reps)
    assert (ours.count, ours.reps) == tuple(pred_to_count(preds, step=8)) \
        == tuple(jpred_to_count(preds, step=8))


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) of TSM-R18 at 32 px, fp32, 11 classes, on
    the same numpy-seeded flax weights."""
    jmodel = JaxTSM(num_class=11, num_segments=8, base_model="resnet18",
                    dropout=0.0, dtype=jnp.float32)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, 8, SIZE, SIZE, 3), jnp.float32), seed=5)
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                     num_segments=8, window_batch=4, image_size=SIZE,
                     gather="host")
    tmodel = TSM(11, 8, "resnet18", dtype=torch.float32)
    load_flax_variables(tmodel, variables)
    teng = InferenceEngine(tmodel, num_segments=8, window_batch=4,
                           image_size=SIZE, device="cpu")
    return jeng, teng


def test_streaming_rep_counter_matches_jax(engines):
    jeng, teng = engines
    ours = streaming.StreamingRepCounter(teng, scale=40)
    theirs = jstreaming.StreamingRepCounter(jeng, scale=40)
    replies = 0
    for frame in _frames(40, 4):
        a, b = ours.push(frame), theirs.push(frame)
        assert (a is None) == (b is None)
        if a is not None:
            replies += 1
            assert {k: a[k] for k in ("state", "count", "reps",
                                      "rep_completed")} == \
                {k: b[k] for k in ("state", "count", "reps", "rep_completed")}
            np.testing.assert_allclose(a["scores"], b["scores"], atol=TOL)
    assert replies == 5
    with pytest.raises(NotImplementedError, match="item 6"):
        streaming.StreamingPeriodicCounter(teng)


# ---------------------------------------------------------------- servers


class _Running:
    """A server with its HTTP listener and its WS loop in a thread."""

    def __init__(self, srv):
        self.srv = srv
        srv.start_http()
        self.thread = threading.Thread(target=asyncio.run,
                                       args=(srv.serve_ws(),), daemon=True)
        self.thread.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", srv.ws_port),
                                         timeout=1).close()
                return
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("the WS listener did not come up")

    def stop(self):
        if self.thread.is_alive():
            self.srv.begin_drain()
            self.thread.join(timeout=30)
        self.srv.shutdown()


def _server_pair(engines, **kw):
    jeng, teng = engines
    return [_Running(cls(eng, host="127.0.0.1", http_port=_free_port(),
                         ws_port=_free_port(), **kw))
            for cls, eng in ((jserver.WorkoutServer, jeng),
                             (tserver.WorkoutServer, teng))]


@pytest.fixture(scope="module")
def servers(engines):
    pair = _server_pair(engines)
    yield [r.srv for r in pair]
    for r in pair:
        r.stop()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, data, ctype=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/video", data=data,
                                 method="POST")
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _close_payloads(got, want):
    assert got["success"] is want["success"] is True
    assert list(got["data"]) == list(want["data"])
    np.testing.assert_allclose(list(got["data"].values()),
                               list(want["data"].values()), atol=TOL)


@pytest.fixture(scope="module")
def upload(tmp_path_factory):
    from workoutdetector_tpu_torch.data.video import write_video
    path = tmp_path_factory.mktemp("upload") / "up.mp4"
    write_video(str(path), _frames(40, 6, h=64, w=64), 30.0)
    return path.read_bytes()


def test_post_video_matches_jax(servers, upload):
    jsrv, tsrv = servers
    _close_payloads(_post(tsrv.http_port, upload),
                    _post(jsrv.http_port, upload))
    body = (b"--BOUND\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"v.mp4\"\r\nContent-Type: application/octet-stream"
            b"\r\n\r\n" + upload + b"\r\n--BOUND--\r\n")
    ctype = "multipart/form-data; boundary=BOUND"
    _close_payloads(_post(tsrv.http_port, body, ctype),
                    _post(jsrv.http_port, body, ctype))
    assert _post(tsrv.http_port, b"") == _post(jsrv.http_port, b"") == \
        {"msg": "No video"}
    bad = _post(tsrv.http_port, b"not a video")
    assert bad["success"] is False


async def _stream(port, frames, mode=None, paced=True):
    """Send ``frames`` as JPEG data URLs (after ``mode:<mode>``), each
    window of 8 followed by its reply when ``paced``; the replies."""
    import websockets
    replies = []
    async with websockets.connect(f"ws://127.0.0.1:{port}/ws/t") as ws:
        if mode:
            await ws.send(f"mode:{mode}")
        for i, frame in enumerate(frames):
            await ws.send(_data_url(frame, "JPEG"))
            if paced and i % 8 == 7:
                replies.append(json.loads(await asyncio.wait_for(
                    ws.recv(), timeout=60)))
        await ws.send("stop")
    return replies


@pytest.mark.parametrize("mode", [None, "count"])
def test_ws_replies_match_jax(servers, mode):
    """Recognize and count mode over the direct WS port of both servers and
    over the port server's HTTP port (the Upgrade splice)."""
    jsrv, tsrv = servers
    frames = _frames(32, 7, h=48, w=64)

    async def drive():
        return await asyncio.gather(_stream(jsrv.ws_port, frames, mode),
                                    _stream(tsrv.ws_port, frames, mode),
                                    _stream(tsrv.http_port, frames, mode))

    want, got, spliced = asyncio.run(drive())
    assert len(want) == len(got) == len(spliced) == 4
    for a, b, c in zip(got, want, spliced):
        if mode == "count":
            keys = ("success", "mode", "count", "state", "rep_completed")
            assert {k: a[k] for k in keys} == {k: b[k] for k in keys} == \
                {k: c[k] for k in keys}
        else:
            _close_payloads(a, b)
            assert a == c


def test_ws_count_periodic_refused_as_jax(servers):
    async def first_reply(port):
        import websockets
        async with websockets.connect(f"ws://127.0.0.1:{port}/ws/p") as ws:
            await ws.send("mode:count-periodic")
            return json.loads(await asyncio.wait_for(ws.recv(), timeout=30))

    jsrv, tsrv = servers
    got = asyncio.run(first_reply(tsrv.ws_port))
    assert got == asyncio.run(first_reply(jsrv.ws_port))
    assert got["success"] is False


def test_healthz_stats_and_static_match_jax(servers):
    jsrv, tsrv = servers
    (tc, th), (jc, jh) = _get(tsrv.http_port, "/healthz"), \
        _get(jsrv.http_port, "/healthz")
    assert tc == jc == 200 and th == jh
    (_, ts), (_, js) = _get(tsrv.http_port, "/stats"), \
        _get(jsrv.http_port, "/stats")
    assert set(ts) == set(js) and set(ts["batcher"]) == set(js["batcher"])
    with urllib.request.urlopen(f"http://127.0.0.1:{tsrv.http_port}/",
                                timeout=10) as r:
        html = r.read().decode()
    assert "Workout Detector" in html and "mode:" in html
    for srv in (tsrv, jsrv):
        s = socket.create_connection(("127.0.0.1", srv.http_port), timeout=10)
        try:
            s.sendall(b"GET /../../../../../../etc/passwd HTTP/1.1\r\n"
                      b"Host: x\r\nConnection: close\r\n\r\n")
            resp = b""
            while chunk := s.recv(4096):
                resp += chunk
        finally:
            s.close()
        assert b"404" in resp.split(b"\r\n", 1)[0] and b"root:" not in resp


def test_warmup_and_drain_match_jax(engines):
    """Warmup before listening (healthz reports it), then begin_drain:
    healthz 503, a connected client's next frame gets the draining notice,
    a new connection is told at once, and serve_ws returns by itself."""
    pair = _server_pair(engines)
    try:
        async def drive(srv):
            import websockets
            uri = f"ws://127.0.0.1:{srv.ws_port}/ws/d"
            async with websockets.connect(uri) as ws:
                # a reply first: the handler is running when the drain starts
                await ws.send("mode:count-periodic")
                await asyncio.wait_for(ws.recv(), 10)
                srv.begin_drain()
                loop = asyncio.get_running_loop()
                code, body = await loop.run_in_executor(
                    None, _get, srv.http_port, "/healthz")
                await ws.send(_data_url(_frames(1, 8)[0], "JPEG"))
                notice = json.loads(await asyncio.wait_for(ws.recv(), 10))
            return code, body["status"], notice

        results = []
        for r in pair:
            assert r.srv._warm is False
            r.srv.warmup()
            assert r.srv._warm is True
            assert _get(r.srv.http_port, "/healthz")[1]["warm"] is True
            results.append(asyncio.run(drive(r.srv)))
            r.thread.join(timeout=30)
            assert not r.thread.is_alive()
        assert results[0] == results[1]
        assert results[1][:2] == (503, "draining") and \
            results[1][2]["draining"] is True
    finally:
        for r in pair:
            r.stop()


def test_splice_ends_when_the_client_closes(engines, monkeypatch):
    """The Upgrade splice over a WS backend that never answers: when the
    client closes, the splice gives the backend SPLICE_CLOSE_GRACE_S to
    close and then ends its thread, instead of waiting for it forever."""
    monkeypatch.setattr(tserver, "SPLICE_CLOSE_GRACE_S", 0.5)
    monkeypatch.setattr(tserver, "SPLICE_POLL_S", 0.1)
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    srv = tserver.WorkoutServer(engines[1], host="127.0.0.1",
                                http_port=_free_port(),
                                ws_port=silent.getsockname()[1])
    srv.start_http()
    try:
        before = threading.active_count()
        c = socket.create_connection(("127.0.0.1", srv.http_port), timeout=10)
        c.sendall(b"GET /ws/x HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                  b"Connection: Upgrade\r\n\r\n")
        up, _ = silent.accept()  # the splice reached the backend
        assert b"Upgrade: websocket" in up.recv(4096)
        t0 = time.time()
        c.close()
        while threading.active_count() > before and time.time() - t0 < 10:
            time.sleep(0.05)
        assert threading.active_count() <= before, "the splice is still up"
        assert time.time() - t0 < 5
        up.close()
    finally:
        silent.close()
        srv.shutdown()


def test_engine_serializes_concurrent_calls(engines):
    """Eight threads scoring through one engine at once (the batcher's
    executor and the HTTP threads) get each its own windows' scores, as
    one thread does."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    teng = engines[1]
    windows = np.random.default_rng(9).integers(
        0, 256, (8, 2, 8, SIZE, SIZE, 3), np.uint8)
    want = [teng.score_windows(w) for w in windows]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(teng.score_windows, windows))
    finally:
        sys.setswitchinterval(prev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_launch_counts_survive_threads():
    import sys
    from workoutdetector_tpu_torch.ops.kernels.library import count_launch

    def fake():
        pass

    fake.launches = 0
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(fake) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert fake.launches == 16 * 2000


def test_server_cli_builds_on_cpu(tmp_path):
    srv = tserver.build_server([
        "--cpu", "--port", str(_free_port()), "model.base_model=resnet18",
        "model.dtype=float32", "data.image_size=32"])
    try:
        assert srv.engine.device.type == "cpu"
        assert srv.engine.window_batch == 16 and srv.engine.image_size == 32
        assert srv.labels == tserver.WORKOUT_LABELS
        assert srv.engine.num_class == 11
    finally:
        srv.shutdown()
    with pytest.raises(NotImplementedError, match="item 6"):
        tserver.build_server(["--cpu", "--repnet-checkpoint", "r.pt2"])


def test_demo_cli_counts_as_the_engine(tmp_path, capsys, engines):
    """The demo CLI over a ``.pt2`` artifact of the R18 model: its count is
    ``count_by_video_model``'s on the artifact's engine, its scores the
    sorted 11-label payload; the tasks of item 6 refuse."""
    from workoutdetector_tpu_torch.data.video import write_video
    from workoutdetector_tpu_torch.infer import (count_by_video_model,
                                                 engine_from_checkpoint)
    from workoutdetector_tpu_torch.serve import demo
    from workoutdetector_tpu_torch.utils.export import export_model
    art = export_model(engines[1].model, str(tmp_path / "m"),
                       (2, 8, SIZE, SIZE, 3), device="cpu")
    path = str(tmp_path / "reps.mp4")
    write_video(path, _frames(48, 10, h=48, w=64), 30.0)
    demo.main(["-i", path, "--task", "count", "--cpu", "--checkpoint", art])
    got = json.loads(capsys.readouterr().out)
    count, reps = count_by_video_model(
        engine_from_checkpoint(None, art, device="cpu"), path)
    assert got == {"count": count, "reps": reps}
    demo.main(["-i", path, "--task", "recognize", "--cpu", "--checkpoint",
               art])
    values = list(json.loads(capsys.readouterr().out).values())
    assert len(values) == 11 and values == sorted(values, reverse=True)
    for task in ("count-similarity", "count-repnet"):
        with pytest.raises(NotImplementedError, match="item 6"):
            demo.main(["-i", path, "--task", task, "--cpu"])
