"""PyTorch port isolation: the port never imports jax or the JAX package,
its kernel modules import without nvcc or triton, and its entry points
refuse to drop to the CPU unless asked."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "workoutdetector_tpu_torch"

_CHILD = r"""
import sys
import numpy as np
import torch
from workoutdetector_tpu_torch.infer import InferenceEngine, count_by_video_model
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.models.convert import random_flax_variables
from workoutdetector_tpu_torch.ops.kernels import _build
model = TSM(3, 4, "resnet50")
load_flax_variables(model, random_flax_variables(model, seed=0))
engine = InferenceEngine(model, num_segments=4, window_batch=2,
                         device="cpu")
video = np.random.default_rng(0).integers(0, 256, (13, 32, 32, 3), np.uint8)
starts, logits = engine.score_video(video, step=4, stride=1)
assert logits.shape == (4, 3) and np.isfinite(logits).all()
assert count_by_video_model(engine, video)[0] == 0  # one 8-frame chunk
from workoutdetector_tpu_torch.models import TimeSformer
ts = TimeSformer(3, 4, 32, 8, 64, 2, 2)
load_flax_variables(ts, random_flax_variables(ts, seed=0))
ts_engine = InferenceEngine(ts, num_segments=4, window_batch=2, device="cpu")
assert ts_engine.model.fold_temporal_fc
starts, logits = ts_engine.score_video(video, step=4, stride=1)
assert logits.shape == (4, 3) and np.isfinite(logits).all()
from workoutdetector_tpu_torch.models import TDN, TPN
tdn = TDN(3, 4)
load_flax_variables(tdn, random_flax_variables(tdn, seed=0))
tdn_engine = InferenceEngine(tdn, num_segments=4, window_batch=2,
                             device="cpu", input_rank=6)
bursts = np.random.default_rng(1).integers(0, 256, (3, 4, 5, 32, 32, 3),
                                           np.uint8)
logits = tdn_engine.score_windows(bursts)
assert logits.shape == (3, 3) and np.isfinite(logits).all()
tpn = TPN(3, 4, "resnet18")
load_flax_variables(tpn, random_flax_variables(tpn, seed=0))
tpn_engine = InferenceEngine(tpn, num_segments=4, window_batch=2, device="cpu")
starts, logits = tpn_engine.score_video(video, step=4, stride=1)
assert logits.shape == (4, 3) and np.isfinite(logits).all()
import json, os, tempfile
import workoutdetector_tpu_torch.settings
import workoutdetector_tpu_torch.data.video
import workoutdetector_tpu_torch.data.repcount
import workoutdetector_tpu_torch.scripts.compare_scores
import workoutdetector_tpu_torch.scripts.eval_count
from workoutdetector_tpu_torch.counting import (analyze_count, eval_score_dir,
                                                obo_mae, scores_to_preds,
                                                to_softmax)
from workoutdetector_tpu_torch.infer import (engine_from_checkpoint,
                                             eval_count_shards, eval_dataset,
                                             inference_dataset,
                                             score_video_chunked)
from workoutdetector_tpu_torch.infer.inference_count import main
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "annotation.csv"), "w") as f:
        f.write(",class_,split,name,vid,start,end,count,reps\n"
                "0,squat,test,a.mp4,x,0,9,2.0,0 2 4 6\n"
                "1,situp,test,b.mp4,y,0,9,1.0,0 4\n")
    files = []
    for i, counts in enumerate(({"a.mp4": 2}, {"b.mp4": 3})):
        files.append(os.path.join(d, f"counts_{i}.json"))
        with open(files[-1], "w") as f:
            json.dump(counts, f)
    main(["--merge-shards"] + files + ["--data-root", d])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "workoutdetector_tpu" or m.startswith("workoutdetector_tpu.")
             or m.split(".")[0] in ("cv2", "pandas"))
assert not bad, bad
assert _build._loaded is None  # a CPU run builds no kernel
print("isolated")
"""


def test_port_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")
    merged = json.loads(out.stdout.strip().splitlines()[-2])
    assert merged == {"mae": 1.0, "obo_acc": 0.5, "n_pred": 2}


_TRAIN_CHILD = r"""
import sys
import numpy as np
import workoutdetector_tpu_torch.trainer
from workoutdetector_tpu_torch.config import Config
from workoutdetector_tpu_torch.train.trainer import Trainer
assert "yaml" not in sys.modules, "yaml imported without a yaml file"
cfg = Config()
cfg.model.base_model, cfg.model.num_segments, cfg.model.num_class = \
    "resnet18", 4, 2
cfg.model.dtype = "float32"
trainer = Trainer(cfg, device="cpu")
state = trainer.init_state(steps_per_epoch=4)
x = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), np.uint8)
m = trainer.train_step(state, x, np.array([0, 1], np.int32))
assert np.isfinite(float(m["loss"])) and state.step == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "workoutdetector_tpu", "yaml"))
assert not bad, bad
print("isolated")
"""


def test_port_trains_without_jax_nor_yaml_in_a_fresh_process():
    """A CPU train step of the port imports none of jax, flax, optax,
    orbax or the JAX package, and a config built in code needs no yaml."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _TRAIN_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_nor_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|msgpack)\b", text, re.M)
    assert not re.search(r"\bworkoutdetector_tpu\b(?!_torch)(\.\w+)*\s+import"
                         r"|import\s+workoutdetector_tpu\b(?!_torch)", text)
    # PyYAML only inside the functions that read or write YAML
    assert not re.search(r"^(import|from)\s+yaml\b", text, re.M)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from workoutdetector_tpu_torch.device import resolve_device
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import TSM
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(TSM(2, 4, "resnet18"))
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config())
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("model_type,base,rank", [("tdn", "resnet50", 6),
                                                  ("tpn", "resnet18", 5),
                                                  ("repnet", "tiny", 5),
                                                  ("image", "resnet18", 4),
                                                  ("image", "convnext_atto", 4)])
def test_engine_from_checkpoint_raises_without_cuda(model_type, base, rank):
    """TDN's rank-6 engine, TPN's, RepNet's and the image models' rank-4
    engines ask
    for the card by default, and raise without one unless the caller names
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.infer import engine_from_checkpoint
    cfg = Config()
    cfg.model.model_type, cfg.model.base_model = model_type, base
    cfg.model.num_segments, cfg.model.num_class = 4, 3
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_from_checkpoint(cfg, None, input_rank=rank)
    eng = engine_from_checkpoint(cfg, None, image_size=32, window_batch=1,
                                 input_rank=rank, device="cpu")
    assert eng.input_rank == rank and eng.device.type == "cpu"


def test_kernel_modules_import_without_toolchain():
    """Importing the kernel modules builds nothing and needs no nvcc or
    triton; the build starts at the first CUDA launch."""
    code = ("import sys; import workoutdetector_tpu_torch.ops.kernels as k; "
            "from workoutdetector_tpu_torch.ops.kernels import _build; "
            "assert _build._loaded is None; "
            "assert 'triton' not in sys.modules; "
            "print(sorted(f.__name__ for f in k.WRAPPERS))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "fused_bottleneck" in out.stdout


_SERVE_CHILD = r"""
import sys, tempfile, os
import numpy as np
import workoutdetector_tpu_torch.serve.server as server
import workoutdetector_tpu_torch.serve.demo
import workoutdetector_tpu_torch.serve.batcher
import workoutdetector_tpu_torch.infer.streaming
import workoutdetector_tpu_torch.utils.export as export
import workoutdetector_tpu_torch.scripts.export_model as export_cli
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in ("websockets", "PIL", "gradio"))
assert not lazy, lazy  # imported only by the functions that use them
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.models.convert import random_flax_variables
model = TSM(3, 4, "resnet18")
load_flax_variables(model, random_flax_variables(model, seed=0))
with tempfile.TemporaryDirectory() as d:
    path = export.export_model(model, os.path.join(d, "m"), (2, 4, 32, 32, 3),
                               device="cpu")
    engine = InferenceEngine.from_exported(path, device="cpu")
    x = np.zeros((3, 4, 32, 32, 3), np.uint8)
    assert engine.score_windows(x).shape == (3, 3)
    srv = server.WorkoutServer(engine, host="127.0.0.1", http_port=0,
                               ws_port=0)
    srv.warmup()
    srv.shutdown()
    export_cli.main(["--cpu", "-o", os.path.join(d, "cli"), "--batch", "1",
                     "model.base_model=resnet18", "data.image_size=32",
                     "model.dtype=float32"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "workoutdetector_tpu" or m.startswith("workoutdetector_tpu."))
assert not bad, bad
print("isolated")
"""


def test_serving_and_export_run_without_jax_in_a_fresh_process():
    """The serving and export modules import no jax and nothing of the JAX
    package (nor websockets, PIL or gradio until a function needs them),
    and export, load and serve a CPU artifact."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SERVE_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


@pytest.mark.parametrize("cli", ["server", "export_model", "demo",
                                 "demo_repnet"])
def test_serving_and_export_clis_raise_without_cuda(cli, tmp_path):
    """Without ``--cpu`` the CLIs ask for the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from workoutdetector_tpu_torch.scripts import export_model
    from workoutdetector_tpu_torch.serve import demo, server
    opts = ["model.base_model=resnet18", "data.image_size=32"]
    run = {"server": lambda: server.build_server(opts),
           "export_model": lambda: export_model.main(
               ["-o", str(tmp_path / "m")] + opts),
           "demo": lambda: demo.main(["-i", str(tmp_path / "v.mp4")] + opts),
           "demo_repnet": lambda: demo.main(
               ["-i", str(tmp_path / "v.mp4"), "--task", "count-repnet",
                "model.base_model=tiny", "data.image_size=32"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        run[cli]()


_IMAGE_CHILD = r"""
import sys
import numpy as np
import torch
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             count_by_image_model,
                                             count_by_motion_periodicity,
                                             count_by_similarity)
from workoutdetector_tpu_torch.infer.inference_count import similarity_engine
from workoutdetector_tpu_torch.models import (ImageClassifier, build_model,
                                              load_flax_variables,
                                              port_convnext_checkpoint,
                                              port_timesformer_checkpoint,
                                              port_vit_checkpoint)
from workoutdetector_tpu_torch.models.convert import random_flax_variables
from workoutdetector_tpu_torch.models.convnext import ConvNeXt
from workoutdetector_tpu_torch.utils import similarity as sim
import workoutdetector_tpu_torch.serve.demo
images = np.random.default_rng(0).integers(0, 256, (5, 32, 32, 3), np.uint8)
for base in ("resnet50", "convnext_atto", "vit_tiny_patch16_224"):
    model = ImageClassifier(base, 2, image_size=32)
    load_flax_variables(model, random_flax_variables(model, seed=0))
    engine = InferenceEngine(model, window_batch=2, image_size=32,
                             device="cpu", input_rank=4)
    logits = engine.score_images(images)
    assert logits.shape == (5, 2) and np.isfinite(logits).all(), base
t = np.arange(96)
feats = np.stack([np.sin(2 * np.pi * t / 24), np.cos(2 * np.pi * t / 24)],
                 1).astype(np.float32)
assert sim.count_by_periodicity(feats, device="cpu")[:2] == (4, 24)
frames = np.zeros((96, 32, 32, 3), np.uint8)
frames[:, :8, :8] = (127 + 100 * np.sin(2 * np.pi * t / 24))[:, None, None,
                                                              None]
assert sim.count_by_spatial_periodicity(frames, grid=4,
                                        device="cpu")[0] == 4
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "workoutdetector_tpu", "matplotlib"))
assert not bad, bad
print("isolated")
"""


def test_image_models_and_counters_run_without_jax_in_a_fresh_process():
    """The image zoo (ConvNeXt, the ViT branch, the ResNet with its head),
    the rank-4 engine, the checkpoint ports, ``utils/similarity`` and the
    counters import no jax, flax or JAX package (nor matplotlib, which only
    ``plot_similarity`` takes), and score and count on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _IMAGE_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


_REPNET_CHILD = r"""
import sys
import numpy as np
import torch
from workoutdetector_tpu_torch.config import Config
from workoutdetector_tpu_torch.data import SyntheticPeriodicDataset
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.infer.inference_count import (
    count_by_repnet, repnet_frame_logits_batch)
from workoutdetector_tpu_torch.infer.streaming import StreamingPeriodicCounter
from workoutdetector_tpu_torch.models import (RepNet, TimeSformer,
                                              count_from_frame_logits,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models.convert import random_flax_variables
from workoutdetector_tpu_torch.train.trainer import Trainer
clip, label = SyntheticPeriodicDataset(8, 4, 24)[3]
assert clip.shape == (8, 24, 24, 3) and label == 3
rep = RepNet(8, 4, 8, 16, 2)
load_flax_variables(rep, random_flax_variables(rep, seed=0))
eng = InferenceEngine(rep, 8, window_batch=2, image_size=24, device="cpu")
fl = repnet_frame_logits_batch(eng)(np.stack([clip] * 3))
assert fl.shape == (3, 8, 4) and np.isfinite(fl).all()
count_from_frame_logits(fl)
counter = StreamingPeriodicCounter(eng, hop=4)
assert [counter.push(f) is None for f in np.concatenate([clip, clip])] \
    == [True] * 7 + [False] + [True] * 3 + [False] + [True] * 3 + [False]
ts = TimeSformer(3, 4, 32, 8, 64, 2, 2, moe_experts=4)
load_flax_variables(ts, random_flax_variables(ts, seed=0))
ts.train()
logits, _, moe = ts(torch.zeros(2, 4, 32, 32, 3))
assert logits.shape == (2, 3) and moe.shape == (4,)
cfg = Config()
cfg.model.model_type, cfg.model.base_model = "timesformer", "custom"
cfg.model.embed_dims, cfg.model.num_layers, cfg.model.num_heads = 64, 1, 2
cfg.model.image_size, cfg.model.patch_size = 32, 8
cfg.model.num_segments, cfg.model.num_class = 4, 2
cfg.model.moe_experts, cfg.model.dtype = 2, "float32"
trainer = Trainer(cfg, device="cpu")
state = trainer.init_state(steps_per_epoch=2)
x = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), np.uint8)
m = trainer.train_step(state, x, np.array([0, 1], np.int32))
assert np.isfinite(float(m["loss"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "workoutdetector_tpu", "pandas"))
assert not bad, bad
print("isolated")
"""


def test_repnet_and_moe_run_without_jax_in_a_fresh_process():
    """RepNet (model, engine, frame logits, the streaming counter), the
    synthetic periodic data and a MoE TimeSformer train step import no
    jax, flax, optax or JAX package (nor pandas), on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _REPNET_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


_PERSON_CHILD = r"""
import os, sys, tempfile
import numpy as np
from workoutdetector_tpu_torch.data.synthetic import (person_dataset,
                                                      pose_dataset,
                                                      person_scene)
from workoutdetector_tpu_torch.data.person import Detector, PersonCrop
from workoutdetector_tpu_torch.data.countix import Countix
from workoutdetector_tpu_torch.models.detector import (LearnedDetectorBackend,
                                                       train_detector)
from workoutdetector_tpu_torch.models.pose import PoseEstimator, train_pose
from workoutdetector_tpu_torch.scripts import bbox, pose
from workoutdetector_tpu_torch.utils import flax_file, view, visualize
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in ("matplotlib", "gradio", "pandas"))
assert not lazy, lazy  # imported only by the functions that use them
imgs, boxes = person_dataset(8, size=32, seed=0)
det = train_detector(imgs, boxes, steps=2, batch=4, device="cpu")
clip = person_scene(np.random.default_rng(1), size=32, t=3)[0]
with tempfile.TemporaryDirectory() as d:
    det.save(os.path.join(d, "det.pt"))
    crop = PersonCrop(Detector("learned", os.path.join(d, "det.pt"),
                               device="cpu"))
    assert crop(clip).ndim == 4
    imgs, kps = pose_dataset(4, size=32, seed=0)
    est = train_pose(imgs, kps, steps=2, batch=2, device="cpu")
    est.save(os.path.join(d, "pose.pt"))
    kp = PoseEstimator.load(os.path.join(d, "pose.pt"),
                            device="cpu").estimate_clip(clip)
    assert kp.shape == (3, 17, 3)
    assert visualize.vis_2d_pose(kp[None], thre=0.0).shape[0] == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "msgpack", "workoutdetector_tpu",
                                    "matplotlib", "pandas"))
assert not bad, bad
print("isolated")
"""


def test_detector_and_pose_run_without_jax_in_a_fresh_process():
    """The detector, person crop, pose, their scripts, the flax file reader,
    Countix and the visualizers import no jax, flax, msgpack or JAX package
    (nor matplotlib, gradio or pandas until a function needs them), and
    train, save, load and run on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PERSON_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


@pytest.mark.parametrize("entry", ["LearnedDetectorBackend.load",
                                   "PoseEstimator.load", "Detector",
                                   "train_detector", "train_pose",
                                   "distill_from_videos", "build_dataset",
                                   "inference_one_video"])
def test_detector_and_pose_entry_points_raise_without_cuda(entry, tmp_path):
    """Each entry point of the detector and pose asks for the card by
    default, and raises without one unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.data.datasets import build_dataset
    from workoutdetector_tpu_torch.data.person import Detector
    from workoutdetector_tpu_torch.models import detector, pose
    from workoutdetector_tpu_torch.scripts import pose as pose_script
    model = detector.CenterNetDetector()
    det_file = str(tmp_path / "det.pt")
    detector.LearnedDetectorBackend(model, device="cpu").save(det_file)
    pose_file = str(tmp_path / "pose.pt")
    pose.PoseEstimator(pose.TopDownPose(), device="cpu").save(pose_file)
    imgs = np.zeros((2, 32, 32, 3), np.uint8)
    cfg = Config().data
    cfg.test.person_crop, cfg.person_backend = True, "learned"
    cfg.person_checkpoint = det_file
    run = {"LearnedDetectorBackend.load":
           lambda: detector.LearnedDetectorBackend.load(det_file),
           "PoseEstimator.load": lambda: pose.PoseEstimator.load(pose_file),
           "Detector": lambda: Detector("learned", det_file),
           "train_detector": lambda: detector.train_detector(
               imgs, [np.zeros((0, 4))] * 2, steps=1),
           "train_pose": lambda: pose.train_pose(
               imgs, [np.zeros((17, 2))] * 2, steps=1),
           "distill_from_videos": lambda: detector.distill_from_videos([]),
           "build_dataset": lambda: build_dataset(cfg, "test"),
           "inference_one_video": lambda: pose_script.inference_one_video(
               str(tmp_path / "v.mp4"), pose_checkpoint=pose_file)}
    with pytest.raises(RuntimeError, match="CUDA"):
        run[entry]()


LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


def test_trainer_without_a_launcher_makes_no_process_group(monkeypatch):
    """One process with no torchrun environment: ``initialize`` does
    nothing, and a ``Trainer`` builds no process group and no mesh and
    trains as before."""
    import torch.distributed as dist

    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.parallel.distributed import (
        initialize, is_main_process)
    from workoutdetector_tpu_torch.train.trainer import Trainer
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize(device="cpu") is None and is_main_process()
    cfg = Config()
    cfg.model.base_model, cfg.model.num_segments, cfg.model.num_class = \
        "resnet18", 2, 2
    cfg.model.dtype = "float32"
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(steps_per_epoch=2)
    x = np.random.default_rng(0).integers(0, 256, (2, 2, 16, 16, 3), np.uint8)
    m = trainer.train_step(state, x, np.array([0, 1], np.int32))
    assert np.isfinite(float(m["loss"]))
    assert trainer.mesh is None and state.layout is None
    assert not dist.is_initialized()


def test_parallel_entry_points_refuse_without_cuda(monkeypatch):
    """The parallel entry points ask for the card by default and raise
    without one, before a process starts; a mesh needs a process group.
    A model that is not bf16 runs the plain path on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from workoutdetector_tpu_torch.models.factory import kernels_for
    from workoutdetector_tpu_torch.parallel import dryrun
    from workoutdetector_tpu_torch.parallel.distributed import (initialize,
                                                                spawn)
    from workoutdetector_tpu_torch.parallel.mesh import (create_mesh,
                                                         prefetch_to_device)
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize("tcp://localhost:1", world_size=2, rank=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([(np.zeros(2),)]), None))
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn(dryrun.run, 2, (None,))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.DryrunSpec()
    spec = dryrun.DryrunSpec(device="cpu")
    spec.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run(0, spec)
    assert [kernels_for(d, t) for d in ("cpu", "cuda")
            for t in ("float32", "bfloat16")] == [True, True, False, True]
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(device="cpu")
    host = next(prefetch_to_device(iter([(np.ones(3),)]), None, device="cpu"))
    assert host[0].device.type == "cpu" and host[0].sum() == 3


def test_spawned_rank_functions_import_no_jax():
    """The rank functions of the parallel tests start in fresh processes
    with torch alone."""
    text = (REPO / "tests" / "torch_parallel_ranks.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text,
                         re.M)
    assert "workoutdetector_tpu." not in text
