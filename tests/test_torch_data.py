"""PyTorch port, the training data path from rawframe files to batches,
against the JAX package on the same files and seeds (CPU).

The corpus is written once for the module: a RepCount-shaped tree of 6
videos (3 train, 2 val, 1 test) of 24 JPEG frames at 64×48, its
``annotation.csv``, and the port's image and rawframe lists. Bounds:

- sampling, transforms, decoded pixels, label lists, items and loader
  batches: bit-identical (byte-identical files), each decoder backend
  against the same backend (native libjpeg through the tracked
  ``native/libwdjpeg.so``, and cv2 with the native library disabled);
- the on-device augment, given the JAX draw: within 1e-4 × 255 of the
  JAX ``device_train_augment`` (both resample in fp32); the port's own
  draws stay inside the candidate and offset sets, flip rate 0.45-0.55
  over 2,000 draws;
- ``resize_center_crop``: within 1e-4 × 255 of the JAX function (the
  same weights, fp32 sums in another order; the JAX result itself lies
  up to ≈ 4.4e-4 from the float64 product at an enlarging shape) and
  within 1e-4 of the float64 product;
- one train step with ``device_augment`` (R18, 32 px, the JAX draw):
  loss within 1e-5, parameters within 1e-4 of the JAX train step.
"""

import csv
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import _cfg as _step_cfg
from test_torch_tsm import randomized_variables
from workoutdetector_tpu.config import Config as JConfig
from workoutdetector_tpu.config import DataConfig as JDataConfig
from workoutdetector_tpu.data import datasets as jdatasets
from workoutdetector_tpu.data import image_folder as jimage_folder
from workoutdetector_tpu.data import jpeg as jjpeg
from workoutdetector_tpu.data import kinetics as jkinetics
from workoutdetector_tpu.data import repcount as jrepcount
from workoutdetector_tpu.data import repcount_datasets as jrcd
from workoutdetector_tpu.data import sampling as jsampling
from workoutdetector_tpu.data import transforms as jtransforms
from workoutdetector_tpu.data.loader import DataLoader as JDataLoader
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.ops import augment as jaugment
from workoutdetector_tpu.ops import preprocess as jpreprocess
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import DataConfig
from workoutdetector_tpu_torch.data import datasets, image_folder, jpeg
from workoutdetector_tpu_torch.data import kinetics, repcount
from workoutdetector_tpu_torch.data import repcount_datasets as rcd
from workoutdetector_tpu_torch.data import sampling, transforms
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.models.convert import flax_to_port_state
from workoutdetector_tpu_torch.ops import augment, preprocess
from workoutdetector_tpu_torch.train.trainer import Trainer

W, H, FRAMES = 64, 48, 24
SIZE, SCALE, SEG = 32, 40, 4
ACTIONS = ["situp", "push_up", "pull_up"]
VIDEOS = [  # (split, action, reps over 24 frames)
    ("train", "situp", [1, 9, 11, 21]),
    ("train", "push_up", [0, 10, 12, 22]),
    ("train", "pull_up", [2, 11, 13, 23]),
    ("val", "situp", [0, 11, 12, 23]),
    ("val", "pull_up", [1, 10, 12, 22]),
    ("test", "push_up", [2, 12, 13, 22]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _frame(rng, k: int, t: int) -> np.ndarray:
    """A 48×64 BGR frame: a bar that moves with t over a per-video tint,
    plus noise (so crops, flips and resizes all change the pixels)."""
    img = np.empty((H, W, 3), np.float32)
    img[:] = (40 + 30 * k, 90, 160 - 20 * k)
    x = 4 + 2 * t
    img[8:40, x:x + 10] = (230, 200 - 6 * t, 60 + 5 * t)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """RepCount-shaped rawframes + annotation.csv + both label lists."""
    root = tmp_path_factory.mktemp("rawframes")
    rng = np.random.default_rng(0)
    rows = [["", "class_", "split", "name", "vid", "start", "end", "count",
             "reps"]]
    for k, (split, action, reps) in enumerate(VIDEOS):
        name = f"{split}{k}"
        d = root / "rawframes" / split / name
        d.mkdir(parents=True)
        for t in range(FRAMES):
            cv2.imwrite(str(d / f"img_{t + 1:05}.jpg"), _frame(rng, k, t))
        rows.append([str(k), action, split, f"{name}.mp4", f"v{k:07d}", "0",
                     str(FRAMES), str(float(len(reps) // 2)),
                     " ".join(map(str, reps))])
    with open(root / "annotation.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    anno = str(root / "annotation.csv")
    repcount.build_video_label_list(str(root), anno, ACTIONS,
                                    str(root / "Binary"))
    repcount.build_label_list(str(root), anno, ACTIONS, str(root / "Images"))
    return root


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' JPEG readers with the native library disabled."""
    monkeypatch.setattr(jpeg, "_load", lambda: None)
    monkeypatch.setattr(jjpeg, "_load", lambda: None)


def _frame_paths(corpus, n=8):
    d = corpus / "rawframes" / "train" / "train0"
    return [str(d / f"img_{t:05}.jpg") for t in range(1, n + 1)]


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("total", [1, 3, 7, 8, 9, 24, 41])
@pytest.mark.parametrize("random", [True, False])
def test_sample_frames_matches_jax(total, random):
    for seed in range(5):
        got = sampling.sample_frames(total, 8, 3, random,
                                     np.random.default_rng(seed))
        want = jsampling.sample_frames(total, 8, 3, random,
                                       np.random.default_rng(seed))
        assert got == want


# ---------------------------------------------------------------- transforms

def _clip(h=48, w=64, t=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


TRANSFORMS = {  # name → (transform from a transforms module, clip (H, W))
    "resize_shrink": (lambda m: lambda c, r: m.resize_clip(c, (30, 20)), (48, 64)),
    "resize_enlarge": (lambda m: lambda c, r: m.resize_clip(c, (70, 90)), (48, 64)),
    "resize_short_wide": (lambda m: lambda c, r: m.resize_short_side(c, 40), (48, 64)),
    "resize_short_tall": (lambda m: lambda c, r: m.resize_short_side(c, 40), (64, 45)),
    "center_crop": (lambda m: lambda c, r: m.center_crop(c, 30), (48, 64)),
    "flip": (lambda m: lambda c, r: m.horizontal_flip(c), (48, 64)),
    "msc_5": (lambda m: m.MultiScaleCrop(), (48, 64)),
    "msc_13": (lambda m: m.MultiScaleCrop(num_fixed_crops=13), (48, 64)),
    "msc_random": (lambda m: m.MultiScaleCrop(random_crop=True), (64, 48)),
    "three_crop_wide": (lambda m: m.ThreeCrop(), (48, 64)),
    "three_crop_tall": (lambda m: m.ThreeCrop(), (64, 48)),
    "train": (lambda m: m.TrainTransform(size=SIZE), (48, 64)),
    "train_no_scales": (lambda m: m.TrainTransform(scales=None, size=224),
                        (240, 320)),
    "test": (lambda m: m.TestTransform(size=SIZE, scale=SCALE), (48, 64)),
    "build_val": (lambda m: m.build_transform("val", size=SIZE, scale=SCALE),
                  (48, 64)),
    "build_augment": (lambda m: m.build_transform(
        "train", size=SIZE, scale=SCALE, device_augment=True), (64, 48)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_are_bit_identical(name):
    make, (h, w) = TRANSFORMS[name]
    port, ref = make(transforms), make(jtransforms)
    for seed in range(6):
        clip = _clip(h, w, seed=seed)
        got = port(clip, np.random.default_rng(seed))
        want = ref(clip, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_build_transform_branches_match_jax():
    for kw in [dict(split="train"), dict(split="val"),
               dict(split="train", device_augment=True),
               dict(split="train", device_augment=True, native_prep=False),
               dict(split="test", native_prep=False)]:
        a = transforms.build_transform(size=SIZE, scale=SCALE, **kw)
        b = jtransforms.build_transform(size=SIZE, scale=SCALE, **kw)
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items() if k != "msc"} == \
            {k: v for k, v in vars(b).items() if k != "msc"}
        assert datasets._prepped_params(a) == jdatasets._prepped_params(b)


# ---------------------------------------------------------------- decode

def test_native_reader_is_bit_identical(corpus, tmp_path):
    assert jpeg.native_available() and jjpeg.native_available()
    paths = _frame_paths(corpus)
    for p in paths[:3]:
        np.testing.assert_array_equal(jpeg.read_image(p), jjpeg.read_image(p))
        np.testing.assert_array_equal(datasets.read_image(p),
                                      jdatasets.read_image(p))
        raw = open(p, "rb").read()
        np.testing.assert_array_equal(jpeg.decode_bytes(raw),
                                      jjpeg.decode_bytes(raw))
    for scale, crop in [(SCALE, SIZE), (40, 40), (64, 56)]:
        got = jpeg.read_batch_prepped(paths, scale, crop)
        assert got.shape == (len(paths), crop, crop, 3)
        np.testing.assert_array_equal(
            got, jjpeg.read_batch_prepped(paths, scale, crop))
    # the cases the native path refuses: both None
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, _frame(np.random.default_rng(1), 0, 0))
    assert jpeg.read_image(png) is None and jjpeg.read_image(png) is None
    assert jpeg.read_batch_prepped(paths + [png], SCALE, SIZE) is None
    assert jpeg.decode_bytes(b"\xff\xd8garbage") is None
    np.testing.assert_array_equal(datasets.read_image(png),
                                  jdatasets.read_image(png))


def test_cv2_reader_is_bit_identical(corpus, no_native):
    paths = _frame_paths(corpus)
    assert not jpeg.native_available() and jpeg.read_image(paths[0]) is None
    assert datasets.decoder_path(transforms.TestTransform()) == "cv2"
    for p in paths[:3]:
        got = datasets.read_image(p)
        assert got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, jdatasets.read_image(p))
    tf = transforms.TestTransform(size=SIZE, scale=SCALE)
    got = datasets._read_clip(paths, tf, None)
    np.testing.assert_array_equal(got, jdatasets._read_clip(
        paths, jtransforms.TestTransform(size=SIZE, scale=SCALE), None))
    with pytest.raises(FileNotFoundError):
        datasets.read_image(str(corpus / "missing.jpg"))


def test_decoder_path_names_the_route():
    assert datasets.decoder_path(transforms.TestTransform()) == "native prepped"
    assert datasets.decoder_path(transforms.TrainTransform()) == "native full"
    assert datasets.decoder_path(
        transforms.TestTransform(in_decoder=False)) == "native full"


# ---------------------------------------------------------------- lists

def test_label_lists_are_byte_identical(corpus, tmp_path):
    anno = str(corpus / "annotation.csv")
    jrepcount.build_video_label_list(str(corpus), anno, ACTIONS,
                                     str(tmp_path / "Binary"))
    jrepcount.build_label_list(str(corpus), anno, ACTIONS,
                               str(tmp_path / "Images"))
    files = sorted(p.relative_to(corpus) for d in ("Binary", "Images")
                   for p in (corpus / d).rglob("*.txt"))
    assert len(files) == 3 + 3 * len(ACTIONS) + 3
    for rel in files:
        assert (corpus / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel
    # 2 reps of 2 halves per train video
    assert len((corpus / "Binary" / "all-train.txt").read_text().split("\n")) \
        == 3 * 4 + 1


def test_rawframe_list_parsing_matches_jax(corpus, tmp_path):
    three = tmp_path / "three.txt"
    three.write_text("a/b 12 3\n\nc 0 1\n")
    four = corpus / "Binary" / "all-train.txt"
    for path, col in [(str(three), 3), (str(four), 4)]:
        for prefix in ("", "/data/x"):
            assert datasets._load_rawframe_anno(path, prefix, col) == \
                jdatasets._load_rawframe_anno(path, prefix, col)


# ---------------------------------------------------------------- datasets

MODES = {  # name → (split, DataConfig overrides)
    "train": ("train", {}),
    "val": ("val", {}),
    "val_host_prep": ("val", {"native_prep": False}),
    "train_device_augment": ("train", {"device_augment": True}),
}


def _data_cfg(cls, corpus, dataset_type, **over):
    cfg = cls()
    cfg.dataset_type = dataset_type
    cfg.data_root = str(corpus)
    cfg.num_segments = SEG
    cfg.image_size, cfg.scale_size = SIZE, SCALE
    cfg.batch_size, cfg.num_workers = 2, 2
    lists = "Binary" if dataset_type == "FrameDataset" else "Images"
    for split in ("train", "val", "test"):
        name = f"all-{split}.txt" if lists == "Binary" else f"{split}.txt"
        getattr(cfg, split).anno = str(corpus / lists / name)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _batches(loader_cls, dataset, shuffle):
    loader = loader_cls(dataset, 2, shuffle=shuffle, num_workers=2, seed=3,
                        drop_last=shuffle)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.extend(loader)
    return out


@pytest.mark.parametrize("dataset_type", ["FrameDataset", "ImageDataset"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_loader_batches_are_bit_identical(corpus, dataset_type, mode, backend,
                                          monkeypatch):
    if backend == "cv2":
        monkeypatch.setattr(jpeg, "_load", lambda: None)
        monkeypatch.setattr(jjpeg, "_load", lambda: None)
    split, over = MODES[mode]
    port = datasets.build_dataset(
        _data_cfg(DataConfig, corpus, dataset_type, **over), split)
    ref = jdatasets.build_dataset(
        _data_cfg(JDataConfig, corpus, dataset_type, **over), split)
    assert type(port).__name__ == type(ref).__name__ == dataset_type
    assert len(port) == len(ref) > 0
    got = _batches(DataLoader, port, split == "train")
    want = _batches(JDataLoader, ref, split == "train")
    assert len(got) == len(want) > 0
    side = SCALE if over.get("device_augment") else SIZE
    frames = SEG if dataset_type == "FrameDataset" else 1
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (2, frames, side, side, 3) and gx.dtype == np.uint8
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_build_dataset_refusals_match_jax(corpus):
    cfg = _data_cfg(DataConfig, corpus, "FrameDataset")
    cfg.val.anno = str(corpus / "Binary" / "missing.txt")
    jcfg = _data_cfg(JDataConfig, corpus, "FrameDataset")
    jcfg.val.anno = cfg.val.anno
    with pytest.raises(AssertionError) as a:
        datasets.build_dataset(cfg, "val")
    with pytest.raises(AssertionError) as b:
        jdatasets.build_dataset(jcfg, "val")
    assert str(a.value) == str(b.value)
    cfg.dataset_type = jcfg.dataset_type = "NoSuchDataset"
    with pytest.raises(KeyError):
        datasets.build_dataset(cfg, "train")
    with pytest.raises(KeyError):
        jdatasets.build_dataset(jcfg, "train")
    ok = _data_cfg(DataConfig, corpus, "FrameDataset")
    ok.train.person_crop = True  # a test-pipeline transform: train ignores it
    assert len(datasets.build_dataset(ok, "train")) == 12


def test_super_image_dataset_matches_jax(corpus):
    frames = sorted(str(p) for p in (corpus / "rawframes").rglob("*.jpg"))
    images = [frames[i:i + 9] for i in range(0, 36, 9)]
    labels = [0, 1, 2, 3]
    for n, tf in [(9, None), (4, "test")]:
        port = datasets.SuperImageDataset(
            images, labels, n, SIZE,
            transforms.TestTransform(SIZE, SCALE) if tf else None)
        ref = jdatasets.SuperImageDataset(
            images, labels, n, SIZE,
            jtransforms.TestTransform(SIZE, SCALE) if tf else None)
        for i in range(len(labels)):
            a, b = port.__getitem__(i, np.random.default_rng(i)), \
                ref.__getitem__(i, np.random.default_rng(i))
            assert a[0].shape == (SIZE, SIZE, 3) and a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError):
        datasets.SuperImageDataset(images, labels, 5)


def _items(port, ref, seeds=2):
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        for s in range(seeds):
            a = port.__getitem__(i, np.random.default_rng(s))
            b = ref.__getitem__(i, np.random.default_rng(s))
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])


def test_repcount_datasets_match_jax(corpus):
    anno = str(corpus / "annotation.csv")
    helper = repcount.RepcountHelper(str(corpus), anno)
    jhelper = jrepcount.RepcountHelper(str(corpus), anno)
    for split in ("train", "val", "test"):
        for action in (None, "situp", "push_up"):
            for max_reps in (2, 1, 0):
                assert rcd.get_video_list(helper, split, action, max_reps) == \
                    jrcd.get_video_list(jhelper, split, action, max_reps)
    tf = (transforms.TrainTransform(size=SIZE),
          jtransforms.TrainTransform(size=SIZE))
    _items(rcd.RepcountImageDataset(str(corpus), "situp", "train", tf[0]),
           jrcd.RepcountImageDataset(str(corpus), "situp", "train", tf[1]))
    _items(rcd.RepcountVideoDataset(str(corpus), "push_up", SEG, "train",
                                    tf[0]),
           jrcd.RepcountVideoDataset(str(corpus), "push_up", SEG, "train",
                                     tf[1]))
    _items(rcd.RepcountRecognitionDataset(str(corpus), "train", ACTIONS, SEG,
                                          tf[0]),
           jrcd.RepcountRecognitionDataset(str(corpus), "train", ACTIONS, SEG,
                                           tf[1]))
    with pytest.raises(ValueError):
        rcd.RepcountImageDataset(str(corpus), "bench_press")


def test_image_folder_dataset_matches_jax(corpus, tmp_path):
    root = tmp_path / "folder"
    for c, (split, name) in enumerate([("train", "train0"), ("val", "val3")]):
        d = root / f"class{c}"
        d.mkdir(parents=True)
        src = corpus / "rawframes" / split / name
        for t in (1, 5):
            (d / f"{t}.jpg").write_bytes((src / f"img_{t:05}.jpg").read_bytes())
        (d / "notes.txt").write_text("not an image")
    tf = transforms.TestTransform(SIZE, SCALE)
    port = image_folder.ImageFolderDataset(str(root), tf)
    ref = jimage_folder.ImageFolderDataset(
        str(root), jtransforms.TestTransform(SIZE, SCALE))
    assert port.classes == ref.classes and port.samples == ref.samples
    _items(port, ref)
    with pytest.raises(NotADirectoryError):
        image_folder.ImageFolderDataset(str(root / "missing"))


SPLIT_CASES = {  # ids → (youtube_id column, directories on disk)
    # an all-digit column is an int column under pandas: "0012345"
    # names the directory 12345_..., "0999" names 999_...
    "all_digits": (["0012345", "0999", "777", "5"],
                   ["12345_000010_000020", "999_000000_000010",
                    "777_000003_000013"]),
    # a text column keeps the zeros; "777" has only a plain-id directory
    "mixed": (["abc_0x", "0999", "777", "5"],
              ["abc_0x_000010_000020", "0999_000000_000010", "777"]),
    # an int id with no {id}_{start}_{end} directory: the plain-id lookup
    # joins a path with an int, a TypeError in both
    "int_plain_id": (["0012345", "0999", "777", "5"],
                     ["12345_000010_000020", "999_000000_000010", "777"]),
}


@pytest.mark.parametrize("ids", sorted(SPLIT_CASES))
def test_split_to_rawframe_list_matches_jax(tmp_path, ids):
    youtube_ids, stems = SPLIT_CASES[ids]
    labels = tmp_path / "labels.csv"
    labels.write_text("id,name\n0,abseiling\n1,squat\n2,situp\n")
    rows = zip(["squat", "situp", "abseiling", "unknown"], youtube_ids,
               [10, 0, 3, 0], [20, 10, 13, 1])
    split = tmp_path / "split.csv"
    split.write_text("label,youtube_id,time_start,time_end,split\n" + "".join(
        f"{lab},{y},{s},{e},train\n" for lab, y, s, e in rows))
    raw = tmp_path / "raw"
    for k, stem in enumerate(stems):
        (raw / stem).mkdir(parents=True)
        for t in range(k + 2):
            (raw / stem / f"img_{t:05}.jpg").write_bytes(b"")
    outs = []
    for fn, name in [(kinetics.split_to_rawframe_list, "port.txt"),
                     (jkinetics.split_to_rawframe_list, "jax.txt")]:
        try:
            n = fn(str(split), str(raw), str(tmp_path / name), str(labels))
        except TypeError as exc:
            n = type(exc).__name__
        outs.append((n, (tmp_path / name).read_text()))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("TypeError" if ids == "int_plain_id" else 3)
    assert kinetics.load_labels(str(labels)) == jkinetics.load_labels(str(labels))


# ---------------------------------------------------------------- augment

def test_crop_candidates_match_jax():
    for base in (SCALE, 256, 97):
        for gap in (0, 1, 2):
            np.testing.assert_array_equal(
                augment.crop_candidates(base, max_wh_scale_gap=gap),
                jaugment.crop_candidates(base, max_wh_scale_gap=gap))


def _jax_draw(key, batch, base):
    keys = jax.random.split(key, batch)
    return np.asarray([[int(v) for v in jaugment.sample_crop_params(k, base)]
                       for k in keys], np.int64)


def test_crop_flip_given_the_jax_draw_matches_jax():
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (6, 3, SCALE, SCALE, 3), dtype=np.uint8)
    for step in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        want = np.asarray(jaugment.device_train_augment_jit(
            jnp.asarray(batch), key, out_size=SIZE))
        params = torch.from_numpy(_jax_draw(key, len(batch), SCALE))
        got = augment.crop_flip(torch.from_numpy(batch), params, SIZE)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 255)
    # a single clip, through the JAX per-clip function
    clip = batch[0]
    for x0, y0, cw, ch in [(0, 0, SCALE, SCALE), (3, 5, 26, 30), (9, 0, 30, 40)]:
        want = np.asarray(jaugment.bilinear_crop_resize(
            jnp.asarray(clip), jnp.int32(x0), jnp.int32(y0), jnp.int32(cw),
            jnp.int32(ch), SIZE))
        got = augment.bilinear_crop_resize(
            torch.from_numpy(clip[None]), *(torch.tensor([v])
                                            for v in (x0, y0, cw, ch)), SIZE)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 255)
    # a window of out_size passes through exactly
    same = augment.bilinear_crop_resize(
        torch.from_numpy(batch[:1]), *(torch.tensor([v]) for v in
                                       (4, 2, SIZE, SIZE)), SIZE)
    np.testing.assert_array_equal(same[0].numpy(),
                                  batch[0, :, 2:2 + SIZE, 4:4 + SIZE])


def test_port_draws_cover_the_host_sets():
    g = torch.Generator().manual_seed(0)
    for crops in (5, 13):
        cand = {tuple(c) for c in augment.crop_candidates(256)}
        msc = transforms.MultiScaleCrop
        offs = msc.FIXED_5 + (msc.EXTRA_8 if crops == 13 else ())
        draws = [augment.sample_crop_params(g, 256, num_fixed_crops=crops)
                 for _ in range(2000)]
        valid = {(ox * ((256 - cw) // 4), oy * ((256 - ch) // 4), cw, ch)
                 for cw, ch in cand for ox, oy in offs}
        seen = {d[:4] for d in draws}
        assert seen == valid  # every draw inside, every pair reached
        flips = sum(d[4] for d in draws)
        assert 0.45 <= flips / len(draws) <= 0.55
    with pytest.raises(ValueError):
        augment.sample_crop_params(g, 256, num_fixed_crops=7)
    with pytest.raises(ValueError):
        augment.device_train_augment(torch.zeros(2, 3, 40, 30, 3,
                                                 dtype=torch.uint8), g)
    out = augment.device_train_augment(
        torch.zeros(2, 3, SCALE, SCALE, 3, dtype=torch.uint8), g, SIZE)
    assert out.shape == (2, 3, SIZE, SIZE, 3)


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("shape,scale,crop", [
    ((2, 3, 48, 64, 3), 32, 28),     # wide, shrinking
    ((1, 2, 64, 40, 3), 96, 80),     # tall, enlarging
    ((2, 30, 30, 3), 30, 24),        # square, no resize
])
def test_resize_center_crop_matches_jax(shape, scale, crop):
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jpreprocess.resize_center_crop(jnp.asarray(x), scale,
                                                     crop))
    got = preprocess.resize_center_crop(torch.from_numpy(x), scale, crop)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 255)
    # against the float64 product of the same weights
    h, w = shape[-3:-1]
    th, tw = (scale, round(w * scale / h)) if h <= w else \
        (round(h * scale / w), scale)
    x64 = x.astype(np.float64)
    if th != h:
        x64 = np.einsum("...hwc,hy->...ywc", x64, preprocess._triangle_weights(
            h, th).numpy().astype(np.float64))
    if tw != w:
        x64 = np.einsum("...hwc,wx->...hxc", x64, preprocess._triangle_weights(
            w, tw).numpy().astype(np.float64))
    y0, x0 = (th - crop) // 2, (tw - crop) // 2
    np.testing.assert_allclose(got.numpy(),
                               x64[..., y0:y0 + crop, x0:x0 + crop, :],
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------- train step

def _jax_augmented_step(variables, x_u8, y, key, steps_per_epoch):
    """The JAX trainer's train_step body (trainer.py:167-239) with its
    device_augment branch, over TSM-R18 in fp32, jitted over jax arrays."""
    jcfg = _step_cfg("resnet18", JConfig)
    model = JaxTSM(num_class=3, num_segments=SEG, base_model="resnet18",
                   dropout=0.0, dtype=jnp.float32)
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler,
                              variables["params"], steps_per_epoch,
                              jcfg.trainer.max_epochs, partial_bn=True,
                              fc_lr5=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    @jax.jit
    def step(params, stats, opt_state, xb, yb):
        x = j_normalize(jaugment.device_train_augment(xb, key, out_size=SIZE))

        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(1)})
            return cross_entropy_loss(out, yb), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss

    new_params, new_stats, loss = step(params, stats, tx.init(params),
                                       jnp.asarray(x_u8), jnp.asarray(y))
    return {"params": new_params, "batch_stats": new_stats}, float(loss)


def test_device_augment_train_step_matches_jax(corpus):
    """A FrameDataset batch of 40² canvases, one step with the on-device
    augment to 32², the trainer's draw replaced by the JAX step's."""
    from workoutdetector_tpu_torch.config import Config
    cfg = _step_cfg("resnet18", Config)
    cfg.data = _data_cfg(DataConfig, corpus, "FrameDataset",
                         device_augment=True)
    cfg.data.batch_size = 4
    cfg.data.image_size = SIZE
    x_u8, y = next(iter(DataLoader(datasets.build_dataset(cfg.data, "train"),
                                   4, shuffle=True, seed=0, num_workers=2)))
    assert x_u8.shape == (4, SEG, SCALE, SCALE, 3)
    y = np.array([0, 1, 2, 1], np.int32)  # 3 classes at this head
    variables = randomized_variables(
        JaxTSM(num_class=3, num_segments=SEG, base_model="resnet18",
               dropout=0.0, dtype=jnp.float32),
        jnp.zeros((1, SEG, SIZE, SIZE, 3), jnp.float32), seed=2)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 2), 0)
    want, want_loss = _jax_augmented_step(variables, x_u8, y, key, 10)

    trainer = Trainer(cfg, device="cpu")
    own = trainer.augment_params(0, 4, SCALE)
    assert own.shape == (4, 5) and torch.equal(
        own, trainer.augment_params(0, 4, SCALE))
    assert not torch.equal(own, trainer.augment_params(1, 4, SCALE))
    trainer.augment_params = lambda step, n, base: torch.from_numpy(
        _jax_draw(jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 2), step),
                  n, base))
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(np.asarray, want))
    before = flax_to_port_state(variables)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        if got[k].ndim >= 2:
            assert not np.array_equal(ref[k], before[k]), k


def test_fit_trains_on_rawframe_files(corpus, tmp_path):
    """Trainer.fit over FrameDataset lists, host transforms and the
    on-device augment: finite losses, checkpoints, a validation pass."""
    from workoutdetector_tpu_torch.config import Config
    for augment_on in (False, True):
        cfg = _step_cfg("resnet18", Config)
        cfg.data = _data_cfg(DataConfig, corpus, "FrameDataset",
                             device_augment=augment_on)
        cfg.model.num_class = 2 * len(ACTIONS)
        cfg.trainer.max_epochs = 1
        cfg.trainer.log_every_n_steps = 1
        cfg.trainer.default_root_dir = str(tmp_path / f"runs{augment_on}")
        cfg.callbacks.modelcheckpoint.dirpath = str(tmp_path /
                                                    f"ckpt{augment_on}")
        cfg.log.tensorboard_enable = False
        state, history = Trainer(cfg, device="cpu").fit()
        assert state.step == 6  # 12 train clips at batch 2
        assert np.isfinite(history["val/loss"])
        assert 0.0 <= history["val/acc"] <= 1.0
        assert (tmp_path / f"ckpt{augment_on}" / "last").exists()
