"""PyTorch port, RepNet: the period model, its synthetic dataset, its
counters (offline, dataset sweep, streaming, served), its artifacts and its
train step against the JAX package on the CPU in fp32, on the same
numpy-seeded inputs and variables: the JAX model's own tree
(``jax.eval_shape`` of its init) filled from a numpy seed, through
``load_flax_variables``.

Tolerances: per-frame and consensus logits 1e-4 (eval mode, and train mode
on batch statistics, with the updated running statistics); a train step
at the repo's torch↔JAX bar (loss 1e-5, updated parameters and statistics
1e-4); clips and dataset batches bit-identical; counts, periods,
strengths, statuses, MAE/OBO and count JSONs identical. Sizes: width 4,
embed 8, model dim 16, 2 heads, T 8 (16 for the logits) at 24 px (24 → 12 → 6 → 3 → 2:
the encoder's SAME pads at even and odd sizes).
"""

import asyncio
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_serve import _data_url, _free_port, _Running
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.data import datasets as jds
from workoutdetector_tpu.data.loader import DataLoader as JLoader
from workoutdetector_tpu.data.synthetic import build_repcount_corpus
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import inference_count as jic
from workoutdetector_tpu.infer import streaming as jstreaming
from workoutdetector_tpu.models import repnet as jrep
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.serve import server as jserver
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.data import datasets as tds
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.data.video import write_video
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             engine_from_checkpoint)
from workoutdetector_tpu_torch.infer import inference_count as ic
from workoutdetector_tpu_torch.infer import streaming
from workoutdetector_tpu_torch.models import (REPNET_VARIANTS, RepNet,
                                              build_model,
                                              init_flax_variables,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models import repnet as trep
from workoutdetector_tpu_torch.models.convert import flax_to_port_state
from workoutdetector_tpu_torch.scripts import export_model as export_cli
from workoutdetector_tpu_torch.serve import demo
from workoutdetector_tpu_torch.serve import server as tserver
from workoutdetector_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "workoutdetector_tpu/configs/repnet.yaml")
T, S = 8, 24
DIMS = dict(width=4, embed_dim=8, model_dim=16, num_heads=2)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_repnet(t=T):
    return jrep.RepNet(num_segments=t, dropout=0.0, dtype=jnp.float32,
                       **DIMS)


def _port_repnet(t=T):
    return RepNet(t, DIMS["width"], DIMS["embed_dim"], DIMS["model_dim"],
                  DIMS["num_heads"], dropout=0.0)


def filled_variables(model, x, seed):
    """The JAX model's variable tree (``jax.eval_shape`` of its init: no
    compile) filled from a numpy seed: kernels N(0, 1/fan_in) (fan-in
    every axis but the last), biases N(0, 0.2²), scales 1 + N(0, 0.2²),
    running means N(0, 0.2²) and variances U(0.5, 1.5), embeddings
    N(0, 0.02²)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def fill(leaf, shape):
        if leaf in ("kernel", "w1", "w2"):
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        if leaf in ("bias", "b1", "b2", "mean"):
            return rng.normal(0.0, 0.2, shape)
        if leaf == "scale":
            return 1.0 + rng.normal(0.0, 0.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0.0, 0.02, shape)

    def walk(node):
        return {k: walk(a) if isinstance(a, dict) else
                fill(k, a.shape).astype(np.float32) for k, a in node.items()}
    return {c: walk(dict(shapes[c])) for c in ("params", "batch_stats")
            if c in shapes}


def _variables(t=T, seed=0):
    return filled_variables(_jax_repnet(t),
                            jnp.zeros((1, t, S, S, 3), jnp.float32), seed)


@pytest.fixture(scope="module")
def variables():
    """The counters' weights: the head's class-0 (aperiodic) bias lowered
    by 3, so that frames read periodic and the counts are not all 0."""
    v = _variables()
    v["params"]["period_fc"]["bias"][0] -= 3.0
    return v


@pytest.fixture(scope="module")
def engines(variables):
    """(JAX engine, port engine) of the tiny RepNet at T 8, 24 px, window
    batch 4, on the same variables."""
    jeng = JaxEngine(_jax_repnet(), jax.tree_util.tree_map(jnp.asarray,
                                                           variables),
                     num_segments=T, window_batch=4, image_size=S,
                     gather="host")
    model = _port_repnet()
    load_flax_variables(model, variables)
    teng = InferenceEngine(model, T, window_batch=4, image_size=S,
                           device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """An mp4 of 120 synthetic frames (64×80) with a period of 6 frames."""
    clip = tds.synth_periodic_clip(np.random.default_rng(11), 120, 64,
                                   period=6, kind="translate")
    path = tmp_path_factory.mktemp("rep") / "reps.mp4"
    write_video(str(path), np.ascontiguousarray(clip[:, :, :, :]), 30.0)
    return str(path)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("t", [16])
def test_repnet_logits_match_jax_eval_and_train(t):
    """Per-frame and consensus logits in eval mode, and in train mode
    (BN batch statistics) with the running statistics it leaves, within
    1e-4 of the JAX model on the same variables."""
    variables = _variables(t, seed=t)
    jm = _jax_repnet(t)
    x = np.random.default_rng(t).standard_normal((2, t, S, S, 3)).astype(
        np.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)

    @jax.jit
    def run(v, xx):
        ev, ie = jm.apply(v, xx, train=False, mutable=["intermediates"])
        tr, it = jm.apply(v, xx, train=True,
                          mutable=["intermediates", "batch_stats"])
        return (ev, ie["intermediates"]["aux_logits"][0], tr,
                it["intermediates"]["aux_logits"][0], it["batch_stats"])

    ev, ev_frames, tr, tr_frames, stats = run(jv, jnp.asarray(x))
    model = _port_repnet(t)
    load_flax_variables(model, variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, got_frames = model(xt), model(xt, per_frame=True)
        model.train()
        tr_got, tr_got_frames = model(xt)
    assert got_frames.shape == (2, t, t // 2) and model.num_class == t // 2
    for a, b in ((got, ev), (got_frames, ev_frames), (tr_got, tr),
                 (tr_got_frames, tr_frames)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    want = flax_to_port_state({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats)})
    own = model.state_dict()
    for k in want:
        np.testing.assert_allclose(own[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_encoder_pads_as_flax_same():
    """24 px → 12 → 6 → 3 → 2: each stride-2 3×3 conv pads (0, 1) at an
    even size and (1, 1) at an odd one, XLA's SAME."""
    from workoutdetector_tpu_torch.ops.conv import same_pads
    sizes, pads = [S], []
    for _ in range(4):
        pads.append(same_pads((sizes[-1],) * 2, (3, 3), (2, 2))[0])
        sizes.append(-(-sizes[-1] // 2))
    assert sizes == [24, 12, 6, 3, 2]
    assert pads == [(0, 1), (0, 1), (0, 1), (1, 1)]


def test_repnet_train_step_matches_jax(monkeypatch):
    """One step of the port's trainer (repnet.yaml narrowed: AdamW, cosine
    with warmup, clip 1, dense per-frame aux CE at weight 0.5, dropout 0)
    from SyntheticPeriodic batches against the JAX trainer's step body."""
    monkeypatch.setitem(REPNET_VARIANTS, "tiny", tuple(DIMS.values()))
    opts = ["model.base_model=tiny", f"model.num_segments={T}",
            f"data.num_segments={T}", f"data.image_size={S}",
            "model.dtype=float32", "model.dropout=0.0", "data.batch_size=4"]
    cfg, jcfg = load_config(YAML, opts), j_load_config(YAML, opts)
    variables = _variables(seed=3)
    ds = tds.build_dataset(cfg.data, "train")
    x_u8, y = next(iter(DataLoader(ds, 4, shuffle=True, seed=0,
                                   num_workers=1)))
    jm = _jax_repnet()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler, params, 10,
                              jcfg.trainer.max_epochs)

    @jax.jit
    def step(params, stats, opt_state, xb, yb):
        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats},
                                j_normalize(xb), train=True,
                                mutable=["batch_stats", "intermediates"])
            aux = upd["intermediates"]["aux_logits"][0]
            loss = cross_entropy_loss(out, yb) + 0.5 * cross_entropy_loss(
                aux.reshape(-1, aux.shape[-1]), jnp.repeat(yb, aux.shape[1]))
            return loss, upd["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss

    new_params, new_stats, want_loss = step(
        params, jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        tx.init(params), jnp.asarray(x_u8), jnp.asarray(y))
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.model, RepNet)
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - float(want_loss)) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(
        np.asarray, {"params": new_params, "batch_stats": new_stats}))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_build_model_and_initializers():
    """``build_model`` builds all three variants from repnet.yaml (num_class
    derived, T // 2; an unknown base the ``base`` variant); the
    initializers: ``pos_embed`` normal(0.02) untruncated (draws beyond 2σ,
    as flax's ``normal``), kernels lecun_normal, biases zero."""
    for base in ("base", "small", "tiny", "other"):
        cfg = load_config(YAML, [f"model.base_model={base}",
                                 "model.num_class=3"])
        m = build_model(cfg.model)
        w, e, d, h = REPNET_VARIANTS.get(base, REPNET_VARIANTS["base"])
        assert isinstance(m, RepNet) and m.num_class == 32
        assert m.dtype == torch.bfloat16 and m.dropout == 0.25
        assert tuple(m.enc_conv3.weight.shape) == (8 * w, 4 * w, 3, 3)
        assert tuple(m.proj.weight.shape) == (d, 64 * 32)
        assert m.attn.num_heads == h and m.embed_dim == e
    v = init_flax_variables(m, seed=0)["params"]
    pos = v["pos_embed"]
    assert abs(pos.std() - 0.02) < 0.002
    assert (np.abs(pos) > 2 * 0.02).mean() > 0.03  # untruncated
    proj = v["proj"]["kernel"]
    assert abs(proj.std() * np.sqrt(proj.shape[0]) - 1) < 0.1
    assert np.abs(proj).max() <= 2 / 0.8796 / np.sqrt(proj.shape[0]) + 1e-6
    assert not v["proj"]["bias"].any()
    jv = jax.eval_shape(lambda: jrep.RepNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 64, 3))))
    assert jax.tree_util.tree_map(lambda a: a.shape, dict(jv["params"])) == \
        jax.tree_util.tree_map(np.shape, v)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("period,mode,kind", [
    (0, None, None), (0, "walk", None), (0, "scalewalk", None),
    (0, "flicker", None), (0, "drift", None), (5, None, None),
    (7, None, "squash"), (4, None, "scale"), (9, None, "swing")])
def test_synth_periodic_clip_is_bit_identical(period, mode, kind):
    a = tds.synth_periodic_clip(np.random.default_rng(period + 3), 24, 40,
                                period=period, mode=mode, kind=kind)
    b = jds.synth_periodic_clip(np.random.default_rng(period + 3), 24, 40,
                                period=period, mode=mode, kind=kind)
    assert a.dtype == np.uint8 and a.shape == (24, 40, 40, 3)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_periodic_batches_are_bit_identical(split):
    """``build_dataset`` (SyntheticPeriodic) items by (split, idx), and the
    loaders' batches with their per-item generators, as JAX's."""
    opts = [f"data.num_segments={T}", "data.image_size=32",
            "data.debug_size=12"]
    ours = tds.build_dataset(load_config(YAML, opts).data, split)
    theirs = jds.build_dataset(j_load_config(YAML, opts).data, split)
    assert len(ours) == len(theirs) == 12 and ours.num_class == T // 2
    for idx in (0, 5):
        (a, la), (b, lb) = ours[idx], theirs[idx]
        assert la == lb and np.array_equal(a, b)
    got = list(DataLoader(ours, 4, shuffle=True, seed=2, num_workers=2))
    want = list(JLoader(ours, 4, shuffle=True, seed=2, num_workers=2))
    assert len(got) == len(want) == 3
    for (a, la), (b, lb) in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.array_equal(np.asarray(la), np.asarray(lb))


# --------------------------------------------------------------- counting
def test_count_from_frame_logits_matches_jax():
    rng = np.random.default_rng(4)
    fl = rng.normal(0, 2, (3, T, T // 2)).astype(np.float32)
    valid = rng.random((3, T)) > 0.2
    for v in (None, valid):
        for mp in (0.3, 0.5, 0.9):
            assert trep.count_from_frame_logits(fl, v, mp) == \
                jrep.count_from_frame_logits(fl, v, mp)
    assert trep.period_of_class(np.arange(4)).tolist() == [1, 2, 3, 4]


@pytest.mark.parametrize("grid", [False, True])
def test_count_by_repnet_matches_jax(engines, video_path, grid):
    """(count, period, strength) over rates (1, 2, 4, 8), with the grid's
    2× decode and quadrants; the frame logits within 1e-4."""
    jeng, teng = engines
    got = ic.count_by_repnet(teng, video_path, grid=grid)
    want = jic.count_by_repnet(jeng, video_path, grid=grid)
    assert got[:2] == want[:2]
    assert abs(got[2] - want[2]) < 1e-5
    assert got[0] > 0
    wins = np.random.default_rng(0).integers(0, 256, (5, T, S, S, 3),
                                             dtype=np.uint8)
    np.testing.assert_allclose(ic.repnet_frame_logits_batch(teng)(wins),
                               jic.repnet_frame_logits_batch(jeng)(wins),
                               rtol=TOL, atol=TOL)


def test_eval_dataset_and_cli_in_repnet_mode(engines, tmp_path):
    """``eval_dataset(model_type='repnet')`` over a 3-video corpus (one
    video made unreadable): MAE/OBO, the counts JSON and the failure
    manifest's names as the JAX package's; the CLI's ``--model-type repnet
    --grid`` equal to ``eval_dataset`` over its own engine."""
    jeng, teng = engines
    root = str(tmp_path / "corpus")
    build_repcount_corpus(root, n_videos=3, size=48,
                          splits=(("val", 1.0),), seed=1)
    names = sorted(os.listdir(os.path.join(root, "videos", "val")))
    with open(os.path.join(root, "videos", "val", names[0]), "wb") as f:
        f.write(b"not a video")
    kw = dict(action=["all"], split="val", data_root=root,
              model_type="repnet", grid=True, on_error="skip")
    got = ic.eval_dataset(teng, counts_out=str(tmp_path / "t" / "c.json"),
                          **kw)
    want = jic.eval_dataset(jeng, counts_out=str(tmp_path / "j" / "c.json"),
                            **kw)
    assert got == want

    def load(tag, *parts):
        with open(os.path.join(tmp_path, tag, *parts)) as f:
            return json.load(f)
    assert load("t", "c.json") == load("j", "c.json")
    assert len(load("t", "c.json")) == 2
    fails = [load(tag, "failures", "shard_0of1.json") for tag in "tj"]
    assert set(fails[0]) == set(fails[1]) == {names[0]}
    assert fails[0][names[0]]["stage"] == fails[1][names[0]]["stage"]

    opts = ["model.base_model=tiny", f"model.num_segments={T}",
            "data.image_size=32", "model.dtype=float32"]
    cli_out = str(tmp_path / "cli.json")
    ic.main(["--eval", "--model-type", "repnet", "--grid", "--cpu", "--cfg",
             YAML, "--data-root", root, "--split", "val", "--counts-out",
             cli_out] + opts)
    eng = engine_from_checkpoint(load_config(YAML, opts), None,
                                 image_size=32, device="cpu")
    ic.eval_dataset(eng, counts_out=str(tmp_path / "e.json"), **kw)
    with open(cli_out) as f, open(tmp_path / "e.json") as g:
        assert json.load(f) == json.load(g)


def test_streaming_periodic_counter_matches_jax(engines):
    """Statuses of the live counter (hop 3, rate 2) frame by frame."""
    jeng, teng = engines
    clip = tds.synth_periodic_clip(np.random.default_rng(5), 60, 48,
                                   period=4, kind="squash")
    ours = streaming.StreamingPeriodicCounter(teng, hop=3, rate=2)
    theirs = jstreaming.StreamingPeriodicCounter(jeng, hop=3, rate=2)
    replies = 0
    for frame in clip:
        a, b = ours.push(frame), theirs.push(frame)
        assert a == b
        replies += a is not None
    assert replies == 8 and ours.fractional > 0
    with pytest.raises(ValueError, match="hop"):
        streaming.StreamingPeriodicCounter(teng, hop=T + 1)


# ---------------------------------------------------- artifacts and serving
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A CPU ``.pt2`` of the tiny variant at T 8, 24 px, batch 2, through
    the export CLI (repnet.yaml, the initializers from seed 0)."""
    path = str(tmp_path_factory.mktemp("art") / "repnet")
    export_cli.main(["--cpu", "-o", path, "--batch", "2", "--cfg", YAML,
                     "model.base_model=tiny", f"model.num_segments={T}",
                     f"data.image_size={S}", "model.dtype=float32"])
    return path + ".pt2"


def test_artifact_gives_the_live_frame_logits_and_counts(artifact,
                                                         video_path):
    """The artifact's graph returns the per-frame logits (B, T, C); its
    engine's frame logits and count equal the live engine's."""
    art = engine_from_checkpoint(None, artifact, device="cpu")
    assert art.meta["model_type"] == "repnet" and art.num_class == T // 2
    assert (art.window_batch, art.num_segments, art.image_size) == (2, T, S)
    cfg = load_config(YAML, ["model.base_model=tiny",
                             f"model.num_segments={T}", "model.dtype=float32"])
    live = engine_from_checkpoint(cfg, None, image_size=S, window_batch=2,
                                  device="cpu")
    wins = np.random.default_rng(1).integers(0, 256, (3, T, S, S, 3),
                                             dtype=np.uint8)
    got = ic.repnet_frame_logits_batch(art)(wins)
    assert got.shape == (3, T, T // 2)
    np.testing.assert_allclose(got, ic.repnet_frame_logits_batch(live)(wins),
                               rtol=1e-5, atol=1e-5)
    assert ic.count_by_repnet(art, video_path) == \
        ic.count_by_repnet(live, video_path)


def test_server_and_demo_take_repnet_artifacts(artifact, video_path, capsys,
                                               tmp_path):
    """``--repnet-checkpoint`` takes a RepNet ``.pt2`` (healthz
    ``periodic``), refuses anything else; a RepNet artifact is refused as
    the main engine; the demo's ``count-repnet`` prints
    ``count_by_repnet``'s result."""
    opts = ["model.base_model=resnet18", "data.image_size=32",
            "model.dtype=float32"]
    srv = tserver.build_server(["--cpu", "--port", str(_free_port()),
                                "--repnet-checkpoint", artifact] + opts)
    try:
        assert srv.periodic_engine.meta["model_type"] == "repnet"
        assert srv.periodic_batcher is not None
    finally:
        srv.shutdown()
    with pytest.raises(SystemExit, match="repnet"):
        tserver.build_server(["--cpu", "--repnet-checkpoint", "r.jaxm"] +
                             opts)
    with pytest.raises(SystemExit, match="per-frame"):
        tserver.build_server(["--cpu", "--checkpoint", artifact])
    demo.main(["-i", video_path, "--task", "count-repnet", "--cpu", "--grid",
               "--checkpoint", artifact])
    got = json.loads(capsys.readouterr().out)
    count, period, strength = ic.count_by_repnet(
        engine_from_checkpoint(None, artifact, device="cpu"), video_path,
        grid=True)
    assert got == {"count": count, "period_frames": period,
                   "strength": round(float(strength), 4)}


def test_ws_count_periodic_matches_jax(engines):
    """Two clients each on a port and a JAX server with the RepNet as the
    periodic engine: every count-periodic status as the JAX server's;
    /stats has the JAX keys with ``periodic_batcher``, /healthz
    ``periodic`` true."""
    import urllib.request
    jeng, teng = engines
    pair = [_Running(cls(eng, host="127.0.0.1", http_port=_free_port(),
                         ws_port=_free_port(), periodic_engine=eng))
            for cls, eng in ((jserver.WorkoutServer, jeng),
                             (tserver.WorkoutServer, teng))]
    clips = [tds.synth_periodic_clip(np.random.default_rng(s), 24, 48,
                                     period=4 + s) for s in (1, 2)]

    async def client(port, clip):
        import websockets
        out = []
        async with websockets.connect(f"ws://127.0.0.1:{port}/ws/p") as ws:
            await ws.send("mode:count-periodic")
            for i, frame in enumerate(clip):
                await ws.send(_data_url(frame, "PNG"))
                if i >= T - 1 and (i + 1 - T) % (T // 2) == 0:
                    out.append(json.loads(await asyncio.wait_for(
                        ws.recv(), timeout=60)))
            await ws.send("stop")
        return out

    async def drive(port):
        return await asyncio.gather(*(client(port, c) for c in clips))

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return json.loads(r.read())
    try:
        want, got = (asyncio.run(drive(r.srv.ws_port)) for r in pair)
        assert got == want and len(got[0]) == 5
        assert got[0][0]["mode"] == "count-periodic"
        (js, ts) = (get(r.srv.http_port, "/stats") for r in pair)
        assert set(ts) == set(js) and "periodic_batcher" in ts
        assert ts["periodic_batcher"]["requests"] == 10
        (jh, th) = (get(r.srv.http_port, "/healthz") for r in pair)
        assert th["periodic"] is jh["periodic"] is True
    finally:
        for r in pair:
            r.stop()
    assert threading.active_count() < 50
