"""PyTorch port, export: the forward kernels as ``wd::`` custom ops, the
``.pt2`` artifact and its engine, and ``port_tsm_checkpoint``, against the
JAX package on the same numpy-seeded weights (CPU, fp32).

Bounds:

- ``torch.library.opcheck`` on every op (schema, fake against real,
  autograd registration, AOT dispatch);
- artifact logits against the JAX ``.jaxm`` artifact of the same weights,
  each through its ``from_exported`` engine: within 1e-4 (the torch↔JAX
  bar of the model tests), TSM-R18 at 32 px and TimeSformer D 64, 2
  layers; the sidecars' keys equal (``device`` for ``platforms``);
- the artifact against the live engine it came from: within 1e-5 (the
  same plain ops in another graph), and its graph calls the ops the live
  forward launches: 10 ``wd.shift_matmul`` and 6 ``wd.fused_bottleneck``
  for TSM-R50, one ``wd.attention`` a layer for TimeSformer;
- ``port_tsm_checkpoint`` against the JAX function on a synthetic
  reference-layout state dict: identical arrays, logits within 1e-4.
"""

import json
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tsm import randomized_variables
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.models import convert as jconvert
from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu.utils import export as jexport
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             engine_from_checkpoint,
                                             inference_dataset,
                                             score_video_chunked)
from workoutdetector_tpu_torch.models import (TSM, TimeSformer,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models import convert
from workoutdetector_tpu_torch.models.convert import (port_state_to_flax,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.scripts import export_model as export_cli
from workoutdetector_tpu_torch.utils import export

SIZE = 32
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSM_YAML = os.path.join(REPO, "workoutdetector_tpu/configs/repcount_12_tsm.yaml")
R18_OPTS = ["model.base_model=resnet18", "model.dtype=float32",
            "data.image_size=32", "model.num_class=6"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _windows(n, seed=0, t=8):
    return np.random.default_rng(seed).integers(
        0, 256, (n, t, SIZE, SIZE, 3), np.uint8)


def op_calls(program) -> Counter:
    """{op: calls} of the wd:: ops in an exported program's graphs."""
    calls = Counter()
    for _, mod in program.graph_module.named_modules():
        for node in getattr(mod, "graph", None).nodes \
                if hasattr(mod, "graph") else ():
            if node.op == "call_function" and \
                    str(node.target).startswith("wd."):
                calls[str(node.target).split(".")[1]] += 1
    return calls


# ---------------------------------------------------------------- the ops


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x = r(8, 3, 5, 16)
    qkv = r(2, 7, 3 * 2 * 16)
    q, k, v = kernels.split_heads(qkv, 2)
    c, f, o = 16, 32, 64
    fused = (x, r(c, f), r(2, f), r(3, 3, f, f), r(2, f), r(f, o), r(2, o),
             r(c, o), r(2, o), 4, 2)
    plain = (r(8, 3, 5, 64), r(64, f), r(2, f), r(3, 3, f, f), r(2, f),
             r(f, 64), r(2, 64), None, None, 1, 0)
    return [("temporal_shift", (x, 4, 8, False)),
            ("temporal_shift", (x, 4, 8, True)),
            ("temporal_shift", (x, 4, 32, False)),  # fold 0: a copy
            ("shift_matmul", (x, r(16, 24), 4, 8)),
            ("fused_bottleneck", fused), ("fused_bottleneck", plain),
            ("fused_bottleneck_wmma", fused),
            ("attention", (q, k, v, 0.25, True)),
            ("attention", (q, k, v, 0.25, False)),
            ("attention_tiled", (q, k, v, 0.25, True))]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_opcheck(case):
    name, args = _op_cases()[case]
    result = torch.library.opcheck(getattr(torch.ops.wd, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_are_the_wrappers_plain_versions():
    """Through the op, a CPU tensor gets the plain version, bit for bit,
    and nothing counts as a launch."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 3, 5, 16, generator=g)
    w = torch.randn(16, 24, generator=g)
    before = kernels.launch_counts()
    assert torch.equal(kernels.shift_matmul(x, w, 4),
                       kernels.shift_matmul_plain(x, w, 4))
    assert torch.equal(kernels.temporal_shift(x, 4, reverse=True),
                       kernels.temporal_shift_plain(x, 4, reverse=True))
    q, k, v = kernels.split_heads(torch.randn(2, 7, 96, generator=g), 2)
    assert torch.equal(kernels.attention(q, k, v, 0.25),
                       kernels.attention_plain(q, k, v, 0.25))
    o, lse = kernels.attention_lse(q, k, v, 0.25)
    o2, lse2 = kernels.attention_lse_plain(q, k, v, 0.25)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert kernels.launch_counts() == before


# ---------------------------------------------------------------- artifacts


@pytest.fixture(scope="module")
def r18():
    """(JAX TSM-R18, its numpy variables, the port model) at 32 px, fp32."""
    jmodel = JaxTSM(num_class=6, num_segments=8, base_model="resnet18",
                    dropout=0.0, dtype=jnp.float32)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, 8, SIZE, SIZE, 3), jnp.float32), seed=11)
    tmodel = TSM(6, 8, "resnet18", dtype=torch.float32)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


SHAPE = (4, 8, SIZE, SIZE, 3)
META = {"model_type": "tsm", "num_class": 6, "checkpoint": None}


@pytest.fixture(scope="module")
def r18_pt2(r18, tmp_path_factory):
    """The port's artifact of the R18 model, batch 4, CPU."""
    return export.export_model(r18[2], str(tmp_path_factory.mktemp("pt2") / "m"),
                               SHAPE, labels=list("abcdef"), device="cpu",
                               meta=META)


def test_tsm_artifact_matches_jax_artifact(r18, r18_pt2, tmp_path):
    jmodel, variables, tmodel = r18
    jpath = jexport.export_model(
        jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
        str(tmp_path / "m"), input_shape=SHAPE, labels=list("abcdef"),
        meta=META)
    tpath = r18_pt2
    assert tpath.endswith(".pt2") and jpath.endswith(".jaxm")
    jeng = JaxEngine.from_exported(jpath)
    teng = InferenceEngine.from_exported(tpath, device="cpu")
    assert (teng.window_batch, teng.num_segments, teng.image_size) == \
        (jeng.window_batch, jeng.num_segments, jeng.image_size) == (4, 8, SIZE)
    assert not teng.supports_device_gather and teng.model is None
    x = _windows(6)  # a batch and a padded tail
    got, want = teng.score_windows(x), jeng.score_windows(x)
    assert got.shape == (6, 6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    live = InferenceEngine(tmodel, 8, 4, image_size=SIZE, device="cpu")
    np.testing.assert_allclose(got, live.score_windows(x), atol=1e-5, rtol=0)
    with open(jpath + ".json") as f:
        jkeys = set(json.load(f))
    with open(tpath + ".json") as f:
        tside = json.load(f)
    assert set(tside) == (jkeys - {"platforms"}) | {"device"}
    assert tside["device"] == "cpu" and tside["input_dtype"] == "uint8"
    assert op_calls(teng._exported.program) == {"temporal_shift": 8}
    # a video through the host gather, whole and chunked, as the live
    # engine's device gather scores it
    video = np.random.default_rng(2).integers(0, 256, (37, SIZE, SIZE, 3),
                                              np.uint8)
    starts, logits = teng.score_video(video, step=8, stride=2)
    np.testing.assert_allclose(
        logits, live.score_video(video, step=8, stride=2)[1], atol=1e-5)
    from workoutdetector_tpu_torch.data.video import write_video
    path = str(tmp_path / "v.mp4")
    write_video(path, np.repeat(video, 2, axis=0), 30.0)
    n, s1, l1 = score_video_chunked(teng, path, chunk_frames=32)
    _, s2, l2 = score_video_chunked(live, path, chunk_frames=32)
    assert n == 74 and np.array_equal(s1, s2)
    np.testing.assert_allclose(l1, l2, atol=1e-5)


def test_tsm_r50_artifact_calls_the_kernel_ops(tmp_path):
    """The main path's model: the artifact's graph holds the 10
    shift-matmul and 6 fused-bottleneck ops a live forward launches, and
    scores as the live engine."""
    model = TSM(5, 8, "resnet50")
    load_flax_variables(model, random_flax_variables(model, seed=0))
    path = export.export_model(model, str(tmp_path / "r50"),
                               (2, 8, SIZE, SIZE, 3), device="cpu")
    eng = InferenceEngine.from_exported(path, device="cpu")
    assert op_calls(eng._exported.program) == {"shift_matmul": 10,
                                               "fused_bottleneck": 6}
    # the folded BN and the kernels' weights are the program's constants,
    # not recomputed in its graph (fold_bn's rsqrt appears nowhere)
    assert eng._exported.program.constants
    assert "rsqrt" not in str(eng._exported.program.graph_module.code) + \
        "".join(str(m.code) for m in
                eng._exported.program.graph_module.modules() if
                hasattr(m, "code"))
    live = InferenceEngine(model, 8, 2, image_size=SIZE, device="cpu")
    x = _windows(2, seed=3)
    np.testing.assert_allclose(eng.score_windows(x), live.score_windows(x),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="exported for cpu"):
        export.load_exported(path, "cuda")


def test_timesformer_artifact_matches_jax_artifact(tmp_path):
    model = TimeSformer(5, 4, SIZE, 8, 64, 2, 1)  # dh 64: the one-block route
    variables = random_flax_variables(model, seed=4)
    load_flax_variables(model, variables)
    jmodel = jts.TimeSformer(num_class=5, num_segments=4, image_size=SIZE,
                             patch_size=8, embed_dims=64, num_layers=2,
                             num_heads=1, dtype=jnp.float32)
    shape = (2, 4, SIZE, SIZE, 3)
    jpath = jexport.export_model(
        jmodel, {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  variables["params"])},
        str(tmp_path / "ts"), input_shape=shape)
    tpath = export.export_model(model, str(tmp_path / "ts"), shape,
                                device="cpu")
    teng = InferenceEngine.from_exported(tpath, device="cpu")
    assert op_calls(teng._exported.program) == {"attention": 2}
    x = _windows(3, seed=5, t=4)
    np.testing.assert_allclose(
        teng.score_windows(x), JaxEngine.from_exported(jpath).score_windows(x),
        atol=TOL, rtol=0)


def test_engine_from_checkpoint_loads_pt2_and_refuses_jaxm(r18_pt2,
                                                           tmp_path):
    from workoutdetector_tpu_torch.config import load_config
    cfg = load_config(TSM_YAML, R18_OPTS)
    eng = engine_from_checkpoint(cfg, r18_pt2, window_batch=16, device="cpu")
    assert eng.window_batch == 4 and eng.labels == list("abcdef")
    assert eng.num_class == 6
    with pytest.raises(ValueError, match="StableHLO"):
        engine_from_checkpoint(cfg, str(tmp_path / "m.jaxm"), device="cpu")


def test_inference_dataset_through_an_artifact(r18, r18_pt2, tmp_path):
    """The sweep with an artifact engine takes the host gather and writes
    the live engine's score JSONs (logits within 1e-5)."""
    from workoutdetector_tpu.data.synthetic import build_repcount_corpus
    _, _, tmodel = r18
    root = str(tmp_path / "corpus")
    build_repcount_corpus(root, n_videos=2, size=48, seed=0)
    dirs = {}
    for tag, eng in (("art", InferenceEngine.from_exported(r18_pt2, "cpu")),
                     ("live", InferenceEngine(tmodel, 8, 4, image_size=SIZE,
                                              device="cpu"))):
        dirs[tag] = str(tmp_path / tag)
        summary = inference_dataset(eng, ["val"], dirs[tag], "ckpt",
                                    data_root=root)
        assert summary["scored"] and not summary["failed"]
    names = sorted(os.listdir(dirs["art"]))
    assert names == sorted(os.listdir(dirs["live"]))
    for name in names:
        with open(os.path.join(dirs["art"], name)) as f:
            a = json.load(f)
        with open(os.path.join(dirs["live"], name)) as f:
            b = json.load(f)
        assert list(a["scores"]) == list(b["scores"])
        np.testing.assert_allclose(
            [list(r.values()) for r in a["scores"].values()],
            [list(r.values()) for r in b["scores"].values()], atol=1e-5)


# ---------------------------------------------------------------- checkpoints


def _reference_state_dict(variables, num_class_rows):
    """A reference-layout TSM state dict from flax variables: JAX
    ``flax_to_torch_dict`` names, DDP's ``module.`` prefix, the shift's
    ``.net.`` wrapper on every conv1, ``new_fc`` for the head, torch
    tensors."""
    sd = {}
    for k, v in jconvert.flax_to_torch_dict(variables).items():
        k = k.replace(".conv1.weight", ".conv1.net.weight") \
            if ".layer" in k else k
        k = k.replace("fc.", "new_fc.") if k.startswith("fc.") else k
        sd["module." + k] = torch.from_numpy(np.ascontiguousarray(v))
    sd["module.base_model.bn1.num_batches_tracked"] = torch.tensor(7)
    if num_class_rows is not None:
        sd["module.new_fc.weight"] = torch.zeros(num_class_rows, 512)
        sd["module.new_fc.bias"] = torch.zeros(num_class_rows)
    return sd


@pytest.mark.parametrize("head_rows", [None, 174])  # same head; a mismatch
def test_port_tsm_checkpoint_matches_jax(r18, tmp_path, head_rows):
    jmodel, variables, _ = r18
    ref = _reference_state_dict(variables, head_rows)
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": ref, "epoch": 3}, path)
    sd, jsd = convert.load_torch_checkpoint(path), \
        jconvert.load_torch_checkpoint(path)
    assert list(sd) == list(jsd)
    fresh = TSM(6, 8, "resnet18", dtype=torch.float32)
    target = port_state_to_flax(fresh.state_dict())
    got = convert.port_tsm_checkpoint(sd, 6, target["params"])
    want = jconvert.port_tsm_checkpoint(jsd, 6, target["params"])
    flat = dict(convert._flatten(got))
    jflat = dict(convert._flatten(jax.tree_util.tree_map(np.asarray, want)))
    assert flat.keys() == jflat.keys()
    for key in flat:
        np.testing.assert_array_equal(flat[key], jflat[key])
    load_flax_variables(fresh, got)
    fc = variables["params"]["fc"] if head_rows is None else \
        target["params"]["fc"]  # a mismatched head keeps the model's own
    jvars = {"params": dict(want["params"], fc=fc),
             "batch_stats": want["batch_stats"]}
    x = _windows(2, seed=6)
    live = InferenceEngine(fresh, 8, 2, image_size=SIZE, device="cpu")
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, jvars),
                     num_segments=8, window_batch=2, image_size=SIZE,
                     gather="host")
    np.testing.assert_allclose(live.score_windows(x), jeng.score_windows(x),
                               atol=TOL, rtol=0)
    assert convert.strip_ddp_prefix({"module.a": 1, "b": 2}) == \
        jconvert.strip_ddp_prefix({"module.a": 1, "b": 2})
    assert convert.strip_shift_wrappers({"x.net.w": 1}) == \
        jconvert.strip_shift_wrappers({"x.net.w": 1})


def test_export_cli_ports_a_reference_checkpoint(r18, r18_pt2, tmp_path,
                                                 capsys):
    """The CLI on a reference checkpoint (``--torch-ckpt``) of the R18
    weights: its artifact scores as the artifact of the model that holds
    them (held to the JAX artifact above), and its sidecar has the JAX
    CLI's keys and values (``input_shape`` from the config)."""
    _, variables, tmodel = r18
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": _reference_state_dict(variables, None)}, path)
    export_cli.main(["--cfg", TSM_YAML, "--torch-ckpt", path, "--batch", "4",
                     "--cpu", "-o", str(tmp_path / "port")] + R18_OPTS)
    assert "exported to" in capsys.readouterr().out
    with open(tmp_path / "port.pt2.json") as f:
        side = json.load(f)
    assert side == {"input_shape": list(SHAPE), "input_dtype": "uint8",
                    "device": "cpu", "labels": None, "num_class": 6,
                    "model_type": "tsm", "checkpoint": path}
    x = _windows(2, seed=7)
    got = InferenceEngine.from_exported(str(tmp_path / "port.pt2"),
                                        "cpu").score_windows(x)
    want = InferenceEngine.from_exported(r18_pt2, "cpu").score_windows(x)
    np.testing.assert_array_equal(got, want)
