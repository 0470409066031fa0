"""Serving: WebSocket webcam streaming + video upload, app-contract
compatible.

Port of ``workoutdetector_tpu/serve/server.py``, a rebuild of the
reference FastAPI server (app/server.py:37-119 + app/inference.py:87-170)
on the standard library's ``http.server`` and the ``websockets`` package:

  * WS ``/ws/{client_id}``, reachable on the HTTP port itself (Upgrade
    requests splice to the in-process WS listener; ws_port = http_port + 1
    stays as a direct alias). Client sends ``data:image/...;base64,<...>``
    text frames (App.tsx:106) or ``stop``; every 8 frames the server
    scores one window and replies ``{"success": true, "data": {label:
    score, ...}}`` sorted by score (app/inference.py:109-111); after
    ``mode:count`` it replies with the running count instead.
  * HTTP ``POST /video``: raw or multipart video bytes → temp file →
    8-frame uniform sample → one scored window → the same JSON shape
    (app/server.py:108-116).
  * HTTP ``GET /`` serves the static frontend (serve/static/), ``/healthz``
    and ``/stats`` the operational state.

All connections share one ``AsyncBatcher``, so concurrent streams
coalesce into full device batches: one ``engine.score_windows`` call,
which runs the model's hand kernels on the card. The engine serializes
its device calls itself (``InferenceEngine``), since the batcher's
executor threads and the HTTP threads call it at once.

``mode:count-periodic`` (RepNet) answers as the JAX server does when it
has no RepNet engine: RepNet is not in the port yet (ROADMAP §1 item 6).
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import os
import socket
import tempfile
import threading
import time
from base64 import b64decode
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.data.sampling import sample_frames
from workoutdetector_tpu_torch.data.transforms import (center_crop,
                                                       resize_short_side)
from workoutdetector_tpu_torch.data.video import VideoReader
from workoutdetector_tpu_torch.infer.engine import InferenceEngine
from workoutdetector_tpu_torch.serve.batcher import AsyncBatcher
from workoutdetector_tpu_torch.settings import WORKOUT_LABELS

log = logging.getLogger("workoutdetector_tpu_torch.serve")

SAMPLE_LENGTH = 8
STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
# the Upgrade splice: how long it waits for its upstream when the WS side
# is silent (a paused webcam, a long score), and how long after the
# client's side has closed it waits for the upstream's close
SPLICE_IDLE_S = 300.0
SPLICE_CLOSE_GRACE_S = 10.0
SPLICE_POLL_S = 1.0


def decode_image_bytes(raw: bytes) -> Tuple[Optional[np.ndarray], str]:
    """Image bytes → (RGB uint8 array, the backend that decoded it): the
    native libjpeg path for JPEG, then PIL (webp, png, EXIF-rotated), then
    ``cv2.imdecode`` where PIL is not installed. Raises if none decodes."""
    from workoutdetector_tpu_torch.data.jpeg import decode_bytes
    img = decode_bytes(raw)
    if img is not None:
        return img, "native"
    try:
        from PIL import Image
    except ImportError:
        import cv2
        bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("cv2.imdecode could not decode the frame")
        return np.ascontiguousarray(bgr[..., ::-1]), "cv2"
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")), "PIL"


def decode_data_url(text: str) -> Optional[np.ndarray]:
    """'data:image/webp;base64,<b64>' → RGB uint8 array (None if not an
    image frame or the payload is corrupt). Mirrors app/server.py:69-78;
    a malformed frame must not kill the connection."""
    if not text.startswith("data:image/"):
        return None
    try:
        return decode_image_bytes(b64decode(text.split(",", 1)[1]))[0]
    except Exception as e:
        log.warning("dropping undecodable frame: %s", e)
        return None


def prep_frames(frames: List[np.ndarray], size: int = 224) -> np.ndarray:
    """Resize(short=256) + CenterCrop(224) over a frame list — the
    serving pipeline geometry (app/inference.py:26-31)."""
    clip = np.stack(frames)
    clip = resize_short_side(clip, 256)
    return center_crop(clip, size)


def scores_to_payload(scores: np.ndarray, labels: List[str]) -> Dict[str, float]:
    """{label: score} sorted by descending score (app/inference.py:73-78)."""
    pairs = sorted(enumerate(scores.tolist()), key=lambda x: x[1], reverse=True)
    return {labels[i]: float(s) for i, s in pairs if i < len(labels)}


def _connection_closed():
    """The websockets package's ConnectionClosed, imported when a handler
    runs; a class nothing raises where the package is missing (a caller
    driving ``_ws_handler`` with its own socket object)."""
    try:
        from websockets.exceptions import ConnectionClosed
    except ImportError:
        class ConnectionClosed(Exception):
            pass
    return ConnectionClosed


class WorkoutServer:
    """Combined HTTP (static + POST /video) and WebSocket server.

    Args:
        engine: InferenceEngine over the action-recognition model.
        labels: class label list (defaults to the 11 Workouts classes).
        host, http_port: HTTP endpoint; WS is served on http_port itself
            (Upgrade splice) AND directly on ws_port (http_port + 1).
        count_engine: engine of the live rep-counting mode (the binary
            state classifier); defaults to ``engine``.
    """

    def __init__(self,
                 engine: InferenceEngine,
                 labels: Optional[List[str]] = None,
                 host: str = "0.0.0.0",
                 http_port: int = 8000,
                 ws_port: Optional[int] = None,
                 batch_delay_ms: float = 10.0,
                 count_engine: Optional[InferenceEngine] = None):
        self.engine = engine
        self.count_engine = count_engine or engine
        self.periodic_engine = None  # RepNet: ROADMAP §1 item 6
        self.labels = labels if labels is not None else list(WORKOUT_LABELS)
        self.host = host
        self.http_port = http_port
        self.ws_port = ws_port if ws_port is not None else http_port + 1
        self.batcher = AsyncBatcher(engine.score_windows,
                                    max_batch=engine.window_batch,
                                    max_delay_ms=batch_delay_ms)
        # count mode scores through a batcher too (per-connection device
        # calls would run N one-window batches for N counting clients);
        # shared with the main batcher when the engines match
        self.count_batcher = self.batcher if self.count_engine is engine \
            else AsyncBatcher(self.count_engine.score_windows,
                              max_batch=self.count_engine.window_batch,
                              max_delay_ms=batch_delay_ms)
        # image decode + resize/crop off the event loop: inline they
        # serialize every client's frames through the loop thread; the
        # decoders and cv2's resize release the GIL in their C loops
        self._prep_pool = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4),
            thread_name_prefix="ws-prep")
        self._httpd: Optional[ThreadingHTTPServer] = None
        # ops counters for /healthz and /stats
        self._t0 = time.time()
        self._ws_active = 0
        self._uploads = 0
        # overload policy: frames evicted oldest-first by per-connection
        # deques while a score is in flight (see _ws_handler)
        self._frames_shed = 0
        # graceful drain (SIGTERM/SIGINT or begin_drain()): /healthz
        # flips to 503, connected WS clients get a draining notice and
        # close after their in-flight frame, and serve_ws exits once
        # active connections hit 0 (or the grace period lapses)
        self._draining = False
        self.drain_grace_s = 10.0
        self._stop_event: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._warm = False

    def stats(self) -> Dict:
        """Operational snapshot served at GET /stats."""
        def bstats(b):
            return None if b is None else {
                "requests": b.n_requests,
                "flushes": b.n_flushes,
                "coalescing": round(b.n_requests / b.n_flushes, 2)
                if b.n_flushes else None,
            }
        out = {
            "uptime_s": round(time.time() - self._t0, 1),
            "ws_active": self._ws_active,
            "uploads": self._uploads,
            "frames_shed": self._frames_shed,
            "window_batch": self.engine.window_batch,
            "num_labels": len(self.labels),
            "batcher": bstats(self.batcher),
        }
        if self.count_batcher is not self.batcher:
            out["count_batcher"] = bstats(self.count_batcher)
        return out

    # ---------------- video upload path ---------------- #
    def inference_video_file(self, path: str) -> Dict:
        """Decode + uniform 8-frame sample + one window score
        (app/inference.py:136-170)."""
        try:
            with VideoReader(path) as r:
                clip = r.read_prepped(256, self.engine.image_size)
        except (IOError, FileNotFoundError) as e:
            return {"success": False, "msg": f"Could not open video: {e}"}
        if len(clip) == 0:
            return {"success": False, "msg": "Could not open video"}
        idx = sample_frames(len(clip), SAMPLE_LENGTH, random=False)
        window = clip[idx]
        scores = self.engine.score_windows(window[None])[0]
        self._uploads += 1
        return {"success": True, "data": scores_to_payload(scores, self.labels)}

    # ---------------- websocket path ---------------- #
    async def _ws_handler(self, websocket) -> None:
        """Per-connection modes:
        - 'recognize' (default): every 8 frames → sorted {label: score}
          (app/inference.py:109-111).
        - 'count': live rep counting (send 'mode:count') — every 8 frames
          → running count + state, through the online counter.
        - 'count-periodic' needs RepNet, which the port does not have
          yet: the client is told so and the connection falls back to
          recognize, as the JAX server does without a RepNet engine.

        Overload policy: frames accumulate in a per-connection
        ``deque(maxlen=8)`` and scoring runs as a task, so the reader keeps
        draining the socket while the device is busy; a client streaming
        faster than its windows score has its OLDEST frames evicted (the
        reference's ``deque(maxlen=...)`` drop, app/server.py:45-48; every
        shed frame counts into GET /stats ``frames_shed``). Count mode
        sheds the same way, as the JAX server does. Scores per connection
        stay serialized (at most one in-flight window), so the count
        stream keeps its order.
        """
        from workoutdetector_tpu_torch.infer.streaming import OnlineRepCounter
        ConnectionClosed = _connection_closed()

        frame_queue: deque = deque(maxlen=SAMPLE_LENGTH)
        mode = "recognize"
        counter: Optional[OnlineRepCounter] = None
        inflight: Optional[asyncio.Task] = None
        self._ws_active += 1

        async def score_and_send(frames: List[np.ndarray], ws_mode: str,
                                 ws_counter) -> None:
            loop = asyncio.get_running_loop()
            try:
                if ws_mode == "count" and ws_counter is not None:
                    window = await loop.run_in_executor(
                        self._prep_pool, prep_frames, frames,
                        self.count_engine.image_size)
                    scores = await self.count_batcher.score(window)
                    state = int(np.argmax(scores))
                    completed = ws_counter.push_state(state)
                    await websocket.send(json.dumps({
                        "success": True,
                        "mode": "count",
                        "count": ws_counter.count,
                        "state": state,
                        "rep_completed": completed,
                    }))
                else:
                    window = await loop.run_in_executor(
                        self._prep_pool, prep_frames, frames,
                        self.engine.image_size)
                    scores = await self.batcher.score(window)
                    await websocket.send(json.dumps({
                        "success": True,
                        "data": scores_to_payload(scores, self.labels),
                    }))
            except ConnectionClosed:
                pass
            except Exception as e:
                # a broken model / bad batch stays observable from the
                # scoring task too
                log.exception("ws scoring failed: %s", e)
                try:
                    await websocket.send(json.dumps(
                        {"success": False, "msg": f"server error: {e}"}))
                except Exception:
                    pass

        def maybe_flush() -> None:
            # spawn a score when a full freshest-window is waiting and
            # nothing is in flight; chained via done-callback so a
            # saturated connection keeps scoring even while the client
            # only sends
            nonlocal inflight
            if len(frame_queue) == SAMPLE_LENGTH and \
                    (inflight is None or inflight.done()):
                frames = list(frame_queue)
                frame_queue.clear()
                inflight = asyncio.create_task(
                    score_and_send(frames, mode, counter))
                inflight.add_done_callback(
                    lambda t: None if t.cancelled() else maybe_flush())

        try:
            if self._draining:  # connection raced the drain start
                await websocket.send(json.dumps(
                    {"success": False, "draining": True,
                     "msg": "server draining"}))
                return
            async for message in websocket:
                if self._draining:
                    # finish nothing new: tell the client and close after
                    # whatever was already in flight
                    await websocket.send(json.dumps(
                        {"success": False, "draining": True,
                         "msg": "server draining"}))
                    break
                if message == "stop":
                    break
                if isinstance(message, str) and message.startswith("mode:"):
                    mode = message.split(":", 1)[1]
                    if mode == "count":
                        counter = OnlineRepCounter(step=SAMPLE_LENGTH)
                    elif mode == "count-periodic":
                        mode = "recognize"
                        await websocket.send(json.dumps({
                            "success": False,
                            "msg": "count-periodic unavailable: server "
                                   "started without a repnet engine"}))
                    frame_queue.clear()
                    continue
                loop = asyncio.get_running_loop()
                frame = await loop.run_in_executor(
                    self._prep_pool, decode_data_url, message) \
                    if isinstance(message, str) else None
                if frame is None:
                    continue
                # shed-oldest overload policy — the deque evicts a frame
                # when full (only possible while a score is in flight; an
                # idle connection flushes at 8)
                if len(frame_queue) == SAMPLE_LENGTH:
                    self._frames_shed += 1
                frame_queue.append(frame)
                maybe_flush()
            if inflight is not None:
                await inflight
                inflight = None
        except ConnectionClosed:
            pass  # client went away mid-stream — normal teardown
        except Exception as e:
            # a broken model / bad batch must be observable: log it and
            # tell the client before closing
            log.exception("ws handler failed: %s", e)
            try:
                await websocket.send(json.dumps(
                    {"success": False, "msg": f"server error: {e}"}))
            except Exception:
                pass
        finally:
            if inflight is not None and not inflight.done():
                inflight.cancel()
            if inflight is not None:
                # retrieve the outcome so a failed in-flight score never
                # logs an "exception was never retrieved" at teardown
                try:
                    await inflight
                except (asyncio.CancelledError, Exception):
                    pass
            self._ws_active -= 1

    # ---------------- http path ---------------- #
    def _make_http_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send_json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            MAX_UPLOAD = 256 * 1024 * 1024  # 256 MB video cap

            def _splice_websocket(self):
                """RFC6455 on the HTTP port itself: the reference React app
                opens ``ws://host:8000/ws/{id}`` on the port FastAPI serves
                HTTP on (app/my-app/src/App.tsx:26, app/server.py:85). An
                Upgrade request is spliced byte for byte to the in-process
                websockets listener (ws_port).

                The splice ends when the upstream closes; when the client's
                side has closed and the upstream has not followed within
                SPLICE_CLOSE_GRACE_S; or when the upstream has been silent
                for SPLICE_IDLE_S, so a hung upstream cannot hold the
                thread forever."""
                ws_host = "127.0.0.1" if server.host in ("0.0.0.0", "")\
                    else server.host
                try:
                    up = socket.create_connection((ws_host, server.ws_port),
                                                  timeout=10)
                except OSError:
                    self._send_json({"msg": "ws backend unavailable"}, 502)
                    return
                # short reads, so the loop below can watch the client side
                up.settimeout(SPLICE_POLL_S)
                self.close_connection = True
                req = self.requestline + "\r\n" + "".join(
                    f"{k}: {v}\r\n" for k, v in self.headers.items()) + "\r\n"
                conn = self.connection
                try:
                    up.sendall(req.encode("latin-1"))

                    def client_to_upstream():
                        # read via rfile: frames the client pipelined
                        # right behind the handshake sit in its buffer,
                        # not on the socket
                        try:
                            while True:
                                data = self.rfile.read1(65536)
                                if not data:
                                    break
                                up.sendall(data)
                        except Exception:
                            pass
                        finally:
                            try:
                                up.shutdown(socket.SHUT_WR)
                            except OSError:
                                pass

                    t = threading.Thread(target=client_to_upstream,
                                         daemon=True)
                    t.start()
                    idle = 0.0
                    while True:
                        try:
                            data = up.recv(65536)
                        except socket.timeout:
                            idle += SPLICE_POLL_S
                            limit = SPLICE_IDLE_S if t.is_alive() \
                                else SPLICE_CLOSE_GRACE_S
                            if idle >= limit:
                                break
                            continue
                        except OSError:
                            break
                        if not data:
                            break
                        idle = 0.0
                        conn.sendall(data)
                    # upstream closed or timed out — handler teardown
                    # closes the client socket, unblocking t
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    t.join(timeout=5)
                finally:
                    up.close()

            def do_POST(self):
                if self.path.rstrip("/") == "/video":
                    length = int(self.headers.get("Content-Length", 0))
                    if length > self.MAX_UPLOAD:
                        self._send_json({"success": False,
                                         "msg": "Video too large"}, 413)
                        return
                    data = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    if "multipart/form-data" in ctype:
                        data = _extract_multipart_file(data, ctype)
                    if not data:
                        self._send_json({"msg": "No video"})
                        return
                    # per-request temp file: ThreadingHTTPServer handles
                    # requests concurrently — a shared path would let one
                    # upload overwrite another mid-score
                    with tempfile.NamedTemporaryFile(
                            suffix=".mp4", delete=False) as f:
                        f.write(data)
                        path = f.name
                    try:
                        self._send_json(server.inference_video_file(path))
                    except Exception as e:
                        log.exception("POST /video failed: %s", e)
                        self._send_json({"success": False,
                                         "msg": f"server error: {e}"}, 500)
                    finally:
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                elif self.path.rstrip("/") == "/image":
                    self._send_json({"msg": "Deprecated"})
                else:
                    self._send_json({"msg": "Not found"}, 404)

            def do_GET(self):
                if self.headers.get("Upgrade", "").lower() == "websocket":
                    self._splice_websocket()
                    return
                path = self.path.split("?")[0]
                if path.rstrip("/") == "/healthz":
                    # liveness/readiness for load balancers: no device
                    # call per probe; 503 while draining
                    self._send_json({
                        "status": "draining" if server._draining else "ok",
                        "model_type": server.engine.meta.get("model_type",
                                                             "tsm"),
                        "periodic": False,
                        "warm": server._warm,
                    }, code=503 if server._draining else 200)
                    return
                if path.rstrip("/") == "/stats":
                    self._send_json(server.stats())
                    return
                if path == "/":
                    path = "/index.html"
                fs_path = os.path.realpath(
                    os.path.join(STATIC_DIR, path.lstrip("/")))
                # containment check: '..' segments (curl --path-as-is)
                # must not escape the static root
                if not fs_path.startswith(
                        os.path.realpath(STATIC_DIR) + os.sep):
                    self._send_json({"msg": "Not found"}, 404)
                elif os.path.isfile(fs_path):
                    with open(fs_path, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    ctype = "text/html" if fs_path.endswith(".html") else \
                        "application/javascript" if fs_path.endswith(".js") else \
                        "text/css" if fs_path.endswith(".css") else \
                        "application/octet-stream"
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send_json({"msg": "Not found"}, 404)

        return Handler

    # ---------------- lifecycle ---------------- #
    def start_http(self) -> threading.Thread:
        self._httpd = ThreadingHTTPServer((self.host, self.http_port),
                                          self._make_http_handler())
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def warmup(self) -> None:
        """Launch every serving kernel BEFORE accepting traffic.

        The first CUDA launch builds the kernel library with nvcc
        (``ops.kernels._build.load``) and cuDNN picks its algorithms, so
        without this the first client window pays seconds, with every
        concurrent request queued behind it. ``run`` warms up before the
        HTTP listener binds, so a load balancer's first successful
        /healthz probe (``warm``: true) implies the kernels are built.
        """
        t0 = time.time()

        def zwin(e):
            s = e.image_size
            return np.zeros((e.window_batch, e.num_segments, s, s, 3),
                            np.uint8)

        self.engine.score_windows(zwin(self.engine))
        if self.count_engine is not self.engine:
            self.count_engine.score_windows(zwin(self.count_engine))
        self._warm = True
        log.info("serving kernels built and launched in %.1fs",
                 time.time() - t0)

    def begin_drain(self) -> None:
        """Start a graceful shutdown (signal-handler and thread safe):
        healthz goes 503, WS clients get a draining notice, serve_ws
        returns once connections finish (bounded by drain_grace_s)."""
        self._draining = True
        loop, ev = self._loop, self._stop_event
        if loop is not None and ev is not None and not loop.is_closed():
            loop.call_soon_threadsafe(ev.set)

    async def serve_ws(self) -> None:
        import signal

        import websockets
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        if self._draining:  # a drain begun before the loop existed
            self._stop_event.set()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._loop.add_signal_handler(sig, self.begin_drain)
            except (NotImplementedError, RuntimeError):
                pass  # non-main thread (tests) or platform without support
        async with websockets.serve(self._ws_handler, self.host, self.ws_port):
            await self._stop_event.wait()
            # drain: handlers see _draining and close after their
            # in-flight frame; bound the wait so a stuck client can't
            # hold the process past its eviction deadline
            t0 = time.time()
            while self._ws_active > 0 and \
                    time.time() - t0 < self.drain_grace_s:
                await asyncio.sleep(0.05)
        # context exit closed the listener + any remaining connections

    def run(self, warmup: bool = True) -> None:
        if warmup:
            print("building and launching the serving kernels...")
            self.warmup()
        self.start_http()
        print(f"HTTP on http://{self.host}:{self.http_port} "
              f"(POST /video, static /, ws://...:{self.http_port}/ws/<id>); "
              f"direct WS alias on ws://{self.host}:{self.ws_port}/ws/<id>")
        asyncio.run(self.serve_ws())
        self.shutdown()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._prep_pool.shutdown(wait=False)


def _extract_multipart_file(body: bytes, content_type: str) -> bytes:
    """Minimal multipart/form-data file extraction (first file part)."""
    try:
        boundary = content_type.split("boundary=")[1].strip().encode()
    except IndexError:
        return b""
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" in part and (b"filename=" in part or b"octet-stream" in part):
            payload = part.split(b"\r\n\r\n", 1)[1]
            # trim exactly the part-terminating CRLF; an unbounded rstrip
            # of {-, \r, \n} would eat real trailing bytes of a binary
            # payload that happens to end in those values
            if payload.endswith(b"\r\n"):
                payload = payload[:-2]
            return payload
    return b""


def build_server(argv: Optional[List[str]] = None) -> WorkoutServer:
    """The server ``main`` runs, from its command line: the engine of
    ``engine_from_checkpoint`` (a port checkpoint, a ``.pt2`` artifact,
    or the initializers from seed 0) on the card, or on the CPU with
    ``--cpu``."""
    import argparse

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.infer.engine import engine_from_checkpoint

    parser = argparse.ArgumentParser(description="WorkoutDetector server")
    parser.add_argument("--cfg", default=None, help="config yaml")
    parser.add_argument("--checkpoint", default=None,
                        help="port checkpoint file or .pt2 artifact")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--num-class", type=int, default=11)
    parser.add_argument("--repnet-checkpoint", default=None,
                        help="RepNet artifact for 'mode:count-periodic' "
                             "(not in the PyTorch port yet)")
    parser.add_argument("--window-batch", type=int, default=None,
                        help="device batch of the serving engine; default "
                             "4 for timesformer, 16 otherwise")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("opts", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)

    if args.repnet_checkpoint:
        raise NotImplementedError(
            "--repnet-checkpoint: RepNet is not in the PyTorch port yet "
            "(ROADMAP §1 item 6)")
    cfg = load_config(args.cfg, args.opts)
    cfg.model.num_class = args.num_class
    window_batch = args.window_batch if args.window_batch else \
        (4 if cfg.model.model_type == "timesformer" else 16)
    engine = engine_from_checkpoint(cfg, args.checkpoint,
                                    image_size=cfg.data.image_size,
                                    window_batch=window_batch,
                                    device="cpu" if args.cpu else "cuda")
    return WorkoutServer(engine, labels=engine.labels, http_port=args.port)


def main(argv: Optional[List[str]] = None) -> None:
    build_server(argv).run()


if __name__ == "__main__":
    main()
