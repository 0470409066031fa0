"""Inference engine: uint8 frame windows → logits on the device.

Port of ``workoutdetector_tpu/infer/engine.py`` (``InferenceEngine``,
``score_video_chunked``, ``engine_from_checkpoint``): windows are scored
in fixed batches of ``window_batch`` (the tail chunk zero-padded, like the
reference's zero-padded tail), the normalize runs on the device, and a
decoded video is staged on the device once (``stage_video``: from the
sweep's decode threads a pinned host copy on the engine's own copy
stream, so the copy of video k+1 overlaps the scoring of video k) and its
sparse windows gathered there
(``score_staged`` → ``ops.preprocess.preprocess_windows``). The JAX
engine pads videos to a length bucket to reuse XLA programs; the port
needs no bucket: padded window starts point at the true end, and the
gather reads zeros past it.

An engine of ``input_rank`` 6 serves TDN: its windows are (N, T, 5, H, W,
C) bursts, scored by ``score_windows`` / ``score_clip``; it has no video
path, as the JAX engine has no burst gather. An engine of ``input_rank``
4 serves the image models: ``score_images`` scores (N, H, W, C) frames
(padded to ``window_batch`` as any window batch), and a headless model's
engine returns its features (N, D).

``InferenceEngine.from_exported`` serves a ``torch.export`` artifact
(``utils/export``) instead of a live model: its windows are gathered on
the host and scored in the artifact's fixed batch, as the JAX engine does
for a ``.jaxm`` artifact.

Over a mesh (``parallel/mesh.py``; every rank builds the engine and calls
it with the same windows and gets the same logits) each window batch is
split over the data-parallel ways and the logits are all-gathered. On a
mesh with ``model`` > 1 the engine holds its own copy of the model laid
out as ``state_sharding`` lays it (1/m of each eligible leaf over
``model``, as the JAX engine partitions its variables) and gathers the
weights before each call and frees them after (``StateLayout``); the
caller's model stays whole. With ``pp_cuts`` the model's segment-ranged forward (TSM,
ResNet and TDN carry ``seg_lo``/``seg_hi``) is cut into one pipeline
stage per rank of the ``model`` axis and runs through
``parallel.pipeline.pipeline_apply_het`` in ``pp_microbatches``
microbatches: stage boundaries travel in the model's dtype, the last
stage's logits as the model computes them (fp32). A mesh engine gathers
video windows on the host.

Device calls of one engine go one at a time (a lock): the server scores
from the batcher's executor threads and from its HTTP threads at once,
and the model's derived-weight caches and the launch order on the
current stream are not safe to share between threads.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from workoutdetector_tpu_torch.data.video import DEFAULT_MAX_FRAMES, VideoReader
from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.timesformer import fold_for_inference
from workoutdetector_tpu_torch.ops.preprocess import (normalize_clip,
                                                      preprocess_windows)
from workoutdetector_tpu_torch.parallel.mesh import (StateLayout, batch_rows,
                                                     dp_size)
from workoutdetector_tpu_torch.parallel.pipeline import pipeline_apply_het


class StagedVideo(NamedTuple):
    """A decoded video on the engine's device (``stage_video``).

    ``ready`` is the copy stream's event after the host-to-device copy
    (None where the copy went on the current stream: on the CPU, or with
    ``pin_memory=False``). ``host`` keeps the pinned source alive while
    the copy may still read it.
    """

    video: torch.Tensor  # (T, H, W, 3) uint8 on the engine's device
    ready: Optional[torch.cuda.Event]
    host: Optional[torch.Tensor]


def check_rank(input_rank: int) -> None:
    """The engine's input ranks: 4 (images), 5 (video windows) and 6
    (TDN's bursts)."""
    if input_rank not in (4, 5, 6):
        raise ValueError(
            f"input_rank {input_rank}: 4 (images), 5 (video) or 6 (TDN)")


class InferenceEngine:
    """Wraps a model into a fixed-batch scoring function on one device.

    Args:
        model: module whose forward(x (B, T, H, W, C) float) → logits.
        num_segments: frames per window (8).
        window_batch: windows scored per device call.
        image_size: spatial size of the input frames (the decode crop).
        device: ``"cuda"`` (default) or ``"cpu"``; raises when CUDA is
            asked for and absent.
        optimize: apply the exact inference rewrites first (a TimeSformer's
            t_fc folded into t_attn.proj on a copy, in fp32; other models
            are left as they are), as the JAX engine does.
        input_rank: 5 for video models, 6 for TDN's (B, T, 5, H, W, C)
            bursts (windows only: ``score_windows``, ``score_clip``), 4 for
            the image models' (B, H, W, C) frames (``score_images``).
        mesh: score each window batch over these ranks (module docstring);
            ``device`` is then the mesh's.
        pp_cuts: segment boundaries of mesh.shape['model'] pipeline stages
            (len == stages + 1, e.g. [0, 3, 6]); needs ``mesh``.
        pp_microbatches: microbatches of a window batch in the pipeline.
    """

    def __init__(self, model: torch.nn.Module, num_segments: int = 8,
                 window_batch: int = 16, image_size: int = 224,
                 device: Union[str, torch.device, None] = "cuda",
                 optimize: bool = True, input_rank: int = 5,
                 mesh=None, pp_cuts: Optional[Sequence[int]] = None,
                 pp_microbatches: int = 2):
        check_rank(input_rank)
        self.mesh = mesh
        self.pp_cuts = list(pp_cuts) if pp_cuts is not None else None
        self.pp_microbatches = int(pp_microbatches)
        if mesh is not None:
            device = mesh.device
            n = dp_size(mesh)
            if window_batch % n:
                raise ValueError(f"window_batch {window_batch} must divide "
                                 f"data-parallel ways {n}")
        if self.pp_cuts is not None:
            if mesh is None:
                raise ValueError("pp-staged serving needs a mesh")
            s = mesh.size("model")
            if len(self.pp_cuts) != s + 1:
                raise ValueError(f"pp_cuts {self.pp_cuts} must define "
                                 f"model={s} stages (len == stages + 1)")
            m = self.pp_microbatches
            if window_batch % m:
                raise ValueError(f"window_batch {window_batch} % "
                                 f"pp_microbatches {m} != 0")
            if (window_batch // m) % n:
                raise ValueError(f"pipeline microbatch {window_batch // m} "
                                 f"must divide the data axis {n}")
        self.device = resolve_device(device)
        self.input_rank = input_rank
        if optimize:
            model = fold_for_inference(model)
        self.model = model.to(self.device).eval()
        self.layout: Optional[StateLayout] = None
        if mesh is not None and self.pp_cuts is None and \
                mesh.size("model") > 1:  # the weights at rest over model
            self.model = copy.deepcopy(self.model)
            self.layout = StateLayout(self.model, mesh)
            self.layout.release()
        self.num_segments = num_segments
        self.window_batch = window_batch
        self.image_size = image_size
        self.labels: Optional[List[str]] = None  # set from an artifact's sidecar
        self.meta: dict = {}
        self._exported = None
        self._setup()

    def _setup(self) -> None:
        self._lock = threading.Lock()
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    @classmethod
    def from_exported(cls, path: str,
                      device: Union[str, torch.device, None] = "cuda"
                      ) -> "InferenceEngine":
        """Engine over a ``.pt2`` artifact (``utils.export``): the JAX
        engine's ``from_exported`` for the port's artifacts. The artifact
        holds the weights, the normalize and its input shape, so
        ``window_batch``, ``num_segments``, ``image_size`` and ``labels``
        come from its sidecar. It has no live model, so videos take the
        host gather (``supports_device_gather`` is False): ``score_video``,
        ``score_video_chunked`` and ``inference_dataset`` gather windows on
        the host and score them with ``score_windows``; a TDN artifact
        (rank 6) scores burst windows only, an image artifact (rank 4)
        images (``score_images``; ``num_segments`` 1)."""
        from workoutdetector_tpu_torch.utils.export import load_exported
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        art = load_exported(path, self.device)
        shape = art.input_shape
        check_rank(len(shape))
        self.input_rank = len(shape)
        self.model = None
        self._exported = art
        self.meta = art.meta
        self.labels = art.meta.get("labels")
        self.window_batch = int(shape[0])
        self.num_segments = int(shape[1]) if len(shape) > 4 else 1
        self.image_size = int(shape[-3])
        self.mesh, self.pp_cuts, self.layout = None, None, None
        self._setup()
        return self

    @property
    def num_class(self) -> int:
        """Classes the engine scores: the live model's, or the artifact
        sidecar's."""
        if self.model is not None:
            return self.model.num_class
        return int(self.meta["num_class"])

    @property
    def supports_device_gather(self) -> bool:
        """True when a video may be staged on the device and its windows
        gathered there: the engine holds a live video model. An artifact
        engine (``from_exported``) scores fixed-shape windows only, so its
        videos take the host gather, as the JAX engine's ``.jaxm`` engines
        do."""
        return self.model is not None and self.input_rank == 5 and \
            self.mesh is None

    def require_video_windows(self) -> None:
        """ValueError for an engine whose windows are not (N, T, H, W, C)
        video windows (rank 6, TDN's bursts; rank 4, images): the video
        paths gather only those."""
        if self.input_rank == 4:
            raise ValueError("a rank-4 engine scores (N, H, W, C) images "
                             "with score_images; it has no video windows")
        if self.input_rank != 5:
            raise ValueError(
                f"a rank-{self.input_rank} engine (TDN's (N, T, 5, H, W, C) "
                "bursts) has no video gather; score burst windows with "
                "score_windows")

    @torch.no_grad()
    def _run(self, windows_u8: torch.Tensor) -> torch.Tensor:
        if self.pp_cuts is not None:
            return self._run_pipelined(windows_u8)
        if self.mesh is not None:
            return self._run_sharded(windows_u8)
        x = windows_u8.to(self.device)
        if self.model is None:
            return self._exported(x)
        return self.model(normalize_clip(x))

    def _run_sharded(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """This rank's block of the window batch, the logits all-gathered
        over the data-parallel ways."""
        lo, hi = batch_rows(windows_u8.shape[0], self.mesh)
        if self.layout is not None:
            self.layout.materialize()
        logits = self.model(normalize_clip(windows_u8[lo:hi].to(self.device)))
        if self.layout is not None:
            self.layout.release()
        if dp_size(self.mesh) == 1:
            return logits
        parts = self.mesh.comm.all_gather(logits.contiguous(),
                                          self.mesh.dp_group)
        return torch.cat(parts)

    def _run_pipelined(self, windows_u8: torch.Tensor) -> torch.Tensor:
        """The segment-ranged forward as pipeline stages over ``model``."""
        model, cuts = self.model, self.pp_cuts
        ring = getattr(model, "dtype", torch.float32)
        last = len(cuts) - 2

        def stage(s):
            def fn(_, act):
                y = model(act, seg_lo=cuts[s], seg_hi=cuts[s + 1])
                return y if s == last else y.to(ring)
            return fn

        x = normalize_clip(windows_u8.to(self.device)).to(ring)
        out = pipeline_apply_het([stage(s) for s in range(last + 1)], None,
                                 x, self.mesh, self.pp_microbatches)
        return out.float()

    # ---------------- core batched call ---------------- #
    def chunked_call(self, fn, arr: np.ndarray) -> np.ndarray:
        """Run ``fn`` over any-N leading-dim input in chunks of
        window_batch, zero-padding the tail chunk to a full batch."""
        wb = self.window_batch
        outs: List[np.ndarray] = []
        for i in range(0, arr.shape[0], wb):
            chunk = arr[i:i + wb]
            pad = wb - chunk.shape[0]
            if pad > 0:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            with self._lock:
                out = fn(torch.from_numpy(np.ascontiguousarray(chunk)))
                outs.append(out.float().cpu().numpy()[:wb - pad])
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def score_windows(self, windows_u8: np.ndarray) -> np.ndarray:
        """Score N windows (N, T, H, W, C) uint8 (a rank-6 engine's (N, T,
        5, H, W, C)) → (N, num_class) logits."""
        return self.chunked_call(self._run, windows_u8)

    def score_images(self, images_u8: np.ndarray) -> np.ndarray:
        """The image models' path: (N, H, W, C) uint8 frames → (N,
        num_class) logits (a headless model's (N, D) features), in batches
        of ``window_batch`` with the tail zero-padded and trimmed
        (``chunked_call``). A rank-4 engine's only call."""
        if self.input_rank != 4:
            raise ValueError(f"score_images needs a rank-4 engine, not "
                             f"rank {self.input_rank}")
        return self.score_windows(images_u8)

    def score_clip(self, clip_u8: np.ndarray) -> np.ndarray:
        """Score one (T, H, W, C) window (rank 6: (T, 5, H, W, C)) →
        (num_class,) logits."""
        return self.score_windows(clip_u8[None])[0]

    # ---------------- video scoring ---------------- #
    def windows_for_video(self, total_frames: int, step: int = 8) -> np.ndarray:
        """Window start indices every ``step`` frames; none for 0 frames."""
        return np.arange(0, max(total_frames, 0), step, dtype=np.int64)

    def gather_windows(self, video_u8: np.ndarray, starts: np.ndarray,
                       stride: int = 2) -> np.ndarray:
        """Host-side sparse gather: frames [s, s+stride, ...], zero past the
        end (reference vid[i:i+16:2] + zero pad)."""
        t = video_u8.shape[0]
        f = self.num_segments
        out = np.zeros((len(starts), f) + video_u8.shape[1:], video_u8.dtype)
        for k, s in enumerate(starts):
            idx = np.arange(s, s + f * stride, stride)
            valid = idx < t
            out[k, :valid.sum()] = video_u8[idx[valid]]
        return out

    def stage_video(self, video_u8: np.ndarray,
                    pin_memory: bool = True) -> StagedVideo:
        """Start the copy of a decoded (T, H, W, 3) uint8 video to the
        device: a pinned host tensor copied with ``non_blocking`` on the
        engine's copy stream, whose event ``score_staged`` waits on. Safe
        to call from decode threads, so the copy of video k+1 overlaps the
        scoring of video k. ``pin_memory=False`` copies the pageable array
        on the current stream, which orders it before the gathers: for a
        caller that scores the video at once (``score_video``,
        ``score_video_chunked``), to which pinning would only add a pinned
        allocation and a host copy."""
        host = torch.from_numpy(np.ascontiguousarray(video_u8))
        if self._copy_stream is None or not pin_memory:
            return StagedVideo(host.to(self.device), None, None)
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            video = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return StagedVideo(video, ready, host)

    @torch.no_grad()
    def score_staged(self, staged: StagedVideo, starts: np.ndarray,
                     stride: int = 2) -> np.ndarray:
        """Score a ``stage_video`` result: per batch of window starts, the
        sparse gather + normalize + model on the device. The current
        stream waits for the copy, and the staged tensor is marked as used
        by it, so its memory is not handed back to the copy stream while
        the gathers still read it. Padded starts point at the true end:
        their windows are zeros, the reference's tail semantics. Needs a
        live model (``supports_device_gather``)."""
        self.require_video_windows()
        if self.model is None:
            raise RuntimeError(
                "the device gather needs the live model; an engine loaded "
                "from an artifact scores host-gathered windows "
                "(score_windows)")
        with self._lock:
            return self._score_staged(staged, starts, stride)

    def _score_staged(self, staged: StagedVideo, starts: np.ndarray,
                      stride: int) -> np.ndarray:
        video = staged.video
        total = video.shape[0]
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.ready)
            video.record_stream(stream)
        starts = np.asarray(starts, np.int64)
        wb = self.window_batch
        outs: List[np.ndarray] = []
        for i in range(0, len(starts), wb):
            chunk = starts[i:i + wb]
            n = len(chunk)
            padded = np.concatenate([chunk, np.full(wb - n, total, np.int64)])
            x = preprocess_windows(video, torch.from_numpy(padded).to(self.device),
                                   num_frames=self.num_segments, stride=stride)
            outs.append(self.model(x).float().cpu().numpy()[:n])
        if not outs:
            return np.zeros((0, self.num_class), np.float32)
        return np.concatenate(outs)

    def score_video(self, video_u8: np.ndarray, step: int = 8,
                    stride: int = 2, starts: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score a whole decoded (T, H, W, C) uint8 video.

        Returns (starts, (N, num_class) logits); ``starts`` defaults to
        every ``step`` frames. A video with no windows gives (0, num_class)
        logits. An artifact engine gathers the windows on the host. A
        rank-6 engine raises ValueError (``require_video_windows``).
        """
        self.require_video_windows()
        if starts is None:
            starts = self.windows_for_video(video_u8.shape[0], step=step)
        starts = np.asarray(starts, np.int64)
        if len(starts) == 0:
            return starts, np.zeros((0, self.num_class), np.float32)
        if not self.supports_device_gather:
            return starts, self.score_windows(
                self.gather_windows(video_u8, starts, stride=stride))
        staged = self.stage_video(video_u8, pin_memory=False)
        return starts, self.score_staged(staged, starts, stride)


def score_video_chunked(engine: InferenceEngine,
                        video_path: str,
                        step: int = 8,
                        stride: int = 2,
                        chunk_frames: int = 1024,
                        scale: int = 256,
                        max_frames: Optional[int] = None
                        ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Bounded-memory decode + score of one video, with the windows of
    decoding the whole video and calling ``score_video``.

    A window at start s reads frames [s, s + num_segments·stride), so
    mid-stream every start whose whole span is decoded is scored and only
    the undecoded-span tail is carried forward; at the end of the stream
    the remaining starts score with the zero-pad tail of the whole-video
    path. Peak frame residency is chunk_frames + span instead of the video
    length. The batches hold other windows than the whole-video path's
    (each group is padded to ``window_batch`` on its own).

    ``max_frames`` defaults to ``VideoReader.read_prepped``'s cap, so a
    source longer than it is cut here exactly where the whole-video decode
    cuts it.

    Returns (total_frames, starts, logits).
    """
    engine.require_video_windows()
    if max_frames is None:
        max_frames = DEFAULT_MAX_FRAMES
    span = engine.num_segments * stride
    if chunk_frames < span:
        raise ValueError(
            f"chunk_frames {chunk_frames} must cover one window span {span}")

    starts_all: List[int] = []
    logits_all: List[np.ndarray] = []
    base = 0  # global frame index of buf[0]
    buf = np.empty((0, engine.image_size, engine.image_size, 3), np.uint8)
    next_start = 0
    with VideoReader(video_path) as r:
        it = r.iter_prepped(scale, engine.image_size, chunk=chunk_frames)
        eof = False
        while not eof:
            chunk = next(it, None)
            if chunk is None:
                eof = True
            else:
                room = max_frames - (base + len(buf))
                if len(chunk) >= room:
                    # cap reached: cut exactly where read_prepped would
                    # and treat it as the end (pad-tail semantics)
                    chunk = chunk[:room]
                    eof = True
                if len(chunk):
                    buf = np.concatenate([buf, chunk]) if buf.size else chunk
            total = base + len(buf)
            group: List[int] = []
            s = next_start
            while s < total and (eof or s + span <= total):
                group.append(s)
                s += step
            if group:
                rel = np.asarray(group, np.int64) - base
                if engine.supports_device_gather:
                    staged = engine.stage_video(buf, pin_memory=False)
                    logits_all.append(engine.score_staged(staged, rel,
                                                          stride=stride))
                else:
                    logits_all.append(engine.score_windows(
                        engine.gather_windows(buf, rel, stride=stride)))
                starts_all.extend(group)
                next_start = s
            if not eof and next_start > base:
                buf = buf[next_start - base:]
                base = next_start
    if logits_all:
        logits = np.concatenate(logits_all)
    else:
        # score_video's (0, num_class) on a video without windows
        logits = np.zeros((0, engine.num_class), np.float32)
    return total, np.asarray(starts_all, np.int64), logits


def engine_from_checkpoint(cfg,
                           checkpoint: Optional[str] = None,
                           image_size: Optional[int] = None,
                           window_batch: Optional[int] = None,
                           input_rank: Optional[int] = None,
                           device: Union[str, torch.device, None] = "cuda"
                           ) -> InferenceEngine:
    """The engine of every CLI: a ``.pt2`` artifact (``from_exported``;
    its sidecar fixes the batch and size), or ``build_model(cfg.model)``
    with the weights of a port checkpoint (a ``CheckpointManager`` file:
    its EMA weights where it has them), or the port's initializers from
    seed 0 where no checkpoint is given. ``input_rank`` defaults to 4 for
    ``model_type: image`` and to 5 otherwise; rank 4 is the image models'
    alone, and they take no other (ValueError)."""
    from workoutdetector_tpu_torch.models import (build_model,
                                                  init_flax_variables,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager

    if checkpoint and checkpoint.endswith(".pt2"):
        return InferenceEngine.from_exported(checkpoint, device=device)
    if checkpoint and checkpoint.endswith(".jaxm"):
        raise ValueError(
            f"{checkpoint}: a .jaxm artifact is the JAX package's StableHLO "
            "export, which the PyTorch port cannot read; export the "
            "checkpoint with the port (scripts/export_model.py) to a .pt2 "
            "artifact")
    device = resolve_device(device)  # before any model is built
    image = cfg.model.model_type.lower() == "image"
    rank = (4 if image else 5) if input_rank is None else input_rank
    check_rank(rank)
    if (rank == 4) != image:
        raise ValueError(f"input_rank {rank} for model_type "
                         f"{cfg.model.model_type!r}: rank 4 (images) is the "
                         "image models' input, and theirs alone")
    model = build_model(cfg.model)
    if checkpoint:
        mgr = CheckpointManager(os.path.dirname(checkpoint) or ".")
        restored = mgr.restore_variables(checkpoint)
        model.load_state_dict({**restored["params"],
                               **restored["batch_stats"]})
    else:
        load_flax_variables(model, init_flax_variables(model, seed=0))
    kwargs = {}
    if image_size is not None:
        kwargs["image_size"] = image_size
    if window_batch is not None:
        kwargs["window_batch"] = window_batch
    return InferenceEngine(model, num_segments=cfg.model.num_segments,
                           device=device, input_rank=rank, **kwargs)
