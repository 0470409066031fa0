"""PyTorch port, data and FSDP parallelism: the mesh, global-batch
BatchNorm, sharded trainer state, the batch and loader shards and the dry
run, held against the JAX package on the 8-device CPU mesh.

One world of 4 gloo ranks on the CPU (``parallel.distributed.spawn``)
runs every scenario once per test run (``torch_parallel_ranks.
parallel_world``, shared by the xdist workers that run this file) while
the JAX references are computed (``torch_parallel_refs``); each test
reads its part. TSM-R18 at 16², 2
segments, fp32, weights carried through ``load_flax_variables``.
Tolerances: a train step's loss rtol 1e-5 and the parameters 1e-4 against
JAX (a whole forward, backward and update in another framework, fp32 sums
in other orders); port against port 1e-6 where the two runs differ only
in the order of a few fp32 sums (the cross-rank BatchNorm and gradient
sums, the clip's global norm over shards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import DRYRUN_PHASES, SPEC_MESHES, SPEC_SHAPES
from torch_parallel_refs import parallel_results
from workoutdetector_tpu.data.loader import DataLoader as JDataLoader
from workoutdetector_tpu.parallel.mesh import create_mesh as j_create_mesh
from workoutdetector_tpu.parallel.mesh import param_spec as j_param_spec
from workoutdetector_tpu.parallel.mesh import \
    state_sharding as j_state_sharding
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.models.convert import flax_to_port_state
from workoutdetector_tpu_torch.models.resnet import BatchNorm
from workoutdetector_tpu_torch.parallel.mesh import _FLAX_ORDER


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return parallel_results(tmp_path_factory)


def _flax_order(spec, shape, kernel):
    """A port spec in the flax layout's dim order."""
    order = _FLAX_ORDER.get(len(shape)) if kernel else None
    if not spec or not order:
        return tuple(spec)
    return tuple(spec[d] for d in order)


def _j_mesh(kw):
    return j_create_mesh(devices=jax.devices()[:4], **kw)


def test_param_spec_matches_the_jax_rule(world):
    """Every shape of the table on (4, 1), (2, 2), (1, 4) and a (2, 1, 2)
    hybrid mesh, with and without FSDP: the port's spec on its layout is
    JAX's on the flax layout, and every rank computes the same."""
    specs = world["ranks"][0]["specs"]
    for r in world["ranks"][1:]:
        assert r["specs"] == specs
    for m, kw in enumerate(SPEC_MESHES):
        jm = _j_mesh(kw)
        for f, fsdp_axis in enumerate((None, "data")):
            for i, (shape, kernel) in enumerate(SPEC_SHAPES):
                want = tuple(j_param_spec(shape, jm, fsdp_axis=fsdp_axis))
                got = specs[m][f][i]
                assert _flax_order(got, shape, kernel) == want, \
                    (kw, fsdp_axis, shape, got, want)


def test_state_sharding_matches_jax_for_every_leaf(world):
    """TSM-R18 on a (2, 2) mesh with FSDP: each port parameter and
    statistic is laid out as JAX lays the flax leaf it maps to."""
    got = world["ranks"][0]["model_specs"]
    jm = _j_mesh(dict(data=2, model=2))

    def zeros(t):  # shape-only leaves: broadcast views, no memory
        return {k: zeros(v) if isinstance(v, dict) else
                np.broadcast_to(np.float32(0), v) for k, v in t.items()}

    tree = zeros(world["shapes"])
    want = jax.tree_util.tree_map(lambda s: tuple(s.spec), j_state_sharding(
        jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                          a.dtype), tree),
        jm, fsdp=True))

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    seen = 0
    for coll in ("params", "batch_stats"):
        for path, spec in walk(want[coll]):
            arr = tree[coll]
            for p in path:
                arr = arr[p]
            node = {coll: {}}
            leaf = node[coll]
            for p in path[:-1]:
                leaf = leaf.setdefault(p, {})
            leaf[path[-1]] = arr
            (key, port_arr), = flax_to_port_state(node).items()
            kernel = path[-1] == "kernel"
            assert _flax_order(got[key], port_arr.shape, kernel) == spec, key
            seen += 1
    assert seen == len(got)
    assert any("data" in s and "model" in s for s in got.values())


def test_dp_step_matches_the_jax_mesh_step(world):
    """2-rank DP (partial BN, fc_lr5, TSN policies, clip 20, SGD momentum):
    two steps and an eval against the JAX trainer on its 8-device data
    mesh — losses rtol 1e-5, every parameter and statistic 1e-4."""
    dp, ref = world["ranks"][0]["dp"], world["jax"]
    np.testing.assert_allclose(dp["losses"], ref["losses"], rtol=1e-5)
    assert dp["eval"]["correct"] == ref["eval"]["correct"]
    assert dp["eval"]["total"] == ref["eval"]["total"] == 8
    np.testing.assert_allclose(dp["eval"]["loss"], ref["eval"]["loss"],
                               rtol=1e-5)
    ratio, worst = world["checks"]["dp_vs_jax"]
    assert ratio <= 1, (worst, ratio)  # every leaf within 1e-4 of JAX's
    # both data ranks hold the same replica
    assert world["ranks"][1]["dp"]["state"] == dp["state"]


def test_fsdp_equals_dp_and_serves_fresh_weights(world):
    """FSDP over the data pair equals DP, and neither its eval nor an
    engine over the trained model reads a weight cache from before the
    steps (an eval filled the caches first)."""
    dp, fs = world["ranks"][0]["dp"], world["ranks"][2]["fsdp"]
    np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-6)
    np.testing.assert_allclose(fs["eval"]["loss"], dp["eval"]["loss"],
                               rtol=1e-6)
    assert fs["eval"]["correct"] == dp["eval"]["correct"]
    assert abs(fs["warm_eval"] - fs["eval"]["loss"]) > 1e-3
    assert fs["state_vs_dp"][0] <= 1, fs["state_vs_dp"]  # within 1e-6
    np.testing.assert_array_equal(fs["engine"], fs["engine_ref"])
    assert fs["held"] and all(f == 0.5 for f in fs["held"].values())


def test_watch_step_norms_are_of_whole_leaves(world):
    """A watch step (``train_step(..., watch=True)``) under DP and under
    FSDP, where each rank holds half of every sharded leaf, taken after
    the two plain steps that the other tests hold: the same labels, the
    gradient norms of FSDP equal DP's and the parameter norms of both
    equal the whole updated parameters' (float64), within 1e-6
    relative."""
    dp = world["ranks"][0]["dp"]["watch"]
    fs = world["ranks"][2]["fsdp"]["watch"]
    assert fs["labels"] == dp["labels"]
    assert len(dp["labels"]) == len(dp["grad"])
    np.testing.assert_allclose(fs["grad"], dp["grad"], rtol=1e-6)
    assert (dp["grad"] > 0).sum() > len(dp["grad"]) // 2
    for w in (dp, fs):
        np.testing.assert_allclose(w["param"], w["whole"], rtol=1e-6)
    np.testing.assert_allclose(fs["param"], dp["param"], rtol=1e-6)
    assert world["ranks"][2]["fsdp"]["held"]  # FSDP shards leaves


def test_fsdp_on_a_2x2_world_holds_its_fraction(world):
    """(data 2, model 2) + FSDP: each rank holds 1/(data·model) of every
    leaf sharded on both axes (1/2 of those on one), and trains as DP."""
    dp = world["ranks"][0]["dp"]
    for r in world["ranks"]:
        g = r["grid"]
        both = [n for n, s in g["specs"].items()
                if "data" in s and "model" in s]
        assert both
        for n, s in g["specs"].items():
            assert g["held"][n] == 1 / (2 ** len([a for a in s if a])), n
        np.testing.assert_allclose(g["losses"], dp["losses"], rtol=1e-6)
        np.testing.assert_allclose(g["eval"]["loss"], dp["eval"]["loss"],
                                   rtol=1e-6)
        assert g["state_vs_dp"][0] <= 1, g["state_vs_dp"]  # within 1e-6


def test_elastic_resume_lands_in_the_new_layout(world):
    """Saved after step 1 at (data 2, model 1) without FSDP, restored at
    (data 1, model 2) with FSDP: the restored leaves lie in the new layout
    and step 2 gives the uninterrupted run's numbers."""
    dp = world["ranks"][0]["dp"]
    for r in world["ranks"][2:]:
        el = r["elastic"]
        assert el["meta"] == {"step": 1}
        assert el["held"] and all(f == 0.5 for f in el["held"].values())
        np.testing.assert_allclose(el["loss"], dp["losses"][1], rtol=1e-5)
        assert el["state_vs_dp"][0] <= 1, el["state_vs_dp"]  # within 1e-4


def test_dp_step_with_dropout_equals_one_process(world):
    """Dropout 0.5: the masks are drawn for the global batch and cut to
    each rank's rows, so the 2-rank step is the one-process step."""
    one = world["one"]["dropout"]
    ratio, worst = world["checks"]["dropout_vs_one"]
    assert ratio <= 1, (worst, ratio)  # every leaf within 1e-6
    assert world["ranks"][1]["dropout"]["state"] == \
        world["ranks"][0]["dropout"]["state"]
    for r in world["ranks"][:2]:
        np.testing.assert_allclose(r["dropout"]["loss"], one["loss"],
                                   rtol=1e-6)


def test_global_batch_norm_equals_one_process(world):
    """Train-mode BatchNorm over two ranks' rows: outputs, input and
    affine gradients and running statistics of the whole batch."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((6, 5, 8)) * 2 + 0.5)
                         .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(np.concatenate(
        [rng.standard_normal((3, 5, 8)).astype(np.float32)] * 2))
    bn = BatchNorm(8).train()
    y = bn(x)
    (y * w).sum().backward()
    parts = [r["bn"] for r in world["ranks"][:2]]
    np.testing.assert_allclose(np.concatenate([p["y"] for p in parts]),
                               y.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([p["x_grad"] for p in parts]),
                               x.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(p["w_grad"] for p in parts),
                               bn.weight.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(p["b_grad"] for p in parts),
                               bn.bias.grad.numpy(), rtol=1e-5, atol=1e-5)
    for p in parts:
        np.testing.assert_allclose(p["mean"], bn.running_mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p["var"], bn.running_var.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_host_batch_shard_follows_the_data_ways(world):
    """(4, 1): block = rank of 4; (2, 2): the data coordinate of 2 (model
    ranks share a block); (1, 4): the whole batch; (2, 1, 2): the slice of
    2."""
    want = [lambda r: (r, 4), lambda r: (r // 2, 2), lambda r: (0, 1),
            lambda r: (r // 2, 2)]
    for r in world["ranks"]:
        assert [tuple(s) for s in r["host_shards"]] == \
            [w(r["rank"]) for w in want]


class _Items:
    """A toy dataset: item i is a frame of value i plus the item's own
    noise (its generator), label i % 3."""

    def __len__(self):
        return 10

    def __getitem__(self, idx, rng=None):
        return (np.full((2, 3), idx, np.int64)
                + rng.integers(0, 100, (2, 3))).astype(np.uint8), idx % 3


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False)])
def test_loader_shards_match_the_jax_loader(drop_last, shuffle):
    """Shard k of 2 yields the JAX loader's shard k of every global batch
    (the padded tail included, a later shard's all pad rows), and the
    shards side by side are the one-process batches."""
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=2, seed=3,
              drop_last=drop_last)
    whole = list(DataLoader(_Items(), **kw))
    shards = [list(DataLoader(_Items(), shard_id=k, num_shards=2, **kw))
              for k in range(2)]
    for k in range(2):
        want = list(JDataLoader(_Items(), shard_id=k, num_shards=2, **kw))
        assert len(shards[k]) == len(want) == len(whole)
        for (x, y), (wx, wy) in zip(shards[k], want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
    for b, (x, y) in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([s[b][0] for s in shards]), x)
        np.testing.assert_array_equal(
            np.concatenate([s[b][1] for s in shards]), y)
    if not drop_last:
        assert (shards[1][-1][1] == -1).all()  # the tail's second block
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(_Items(), batch_size=3, shard_id=0, num_shards=2)


def test_dryrun_phases_over_four_ranks(world):
    """The dry run (``parallel/dryrun.py``, which phase 17 runs) on the CPU,
    its phases but DP and FSDP (run above): the sharded and pp-staged
    engines give the one-shot engine's logits, the count of a video and
    the state walk over its windows; the DividedBlock pipeline and the
    TSM's staged forward equal the sequential ones; the (2, 2, 1) hybrid
    mesh's step with dropout is the one-process step."""
    one = world["one"]["dryrun"]
    for r in world["ranks"]:
        d = r["dryrun"]
        assert set(d["phase_seconds"]) == set(DRYRUN_PHASES)
        for ph in ("serve-float32", "pp-serve-float32"):
            assert d[ph]["max_abs_err"] <= 1e-5
            assert d[ph]["count"] == d[ph]["ref_count"]
            np.testing.assert_array_equal(d[ph]["states"],
                                          d[ph]["ref_states"])
            assert len(set(d[ph]["states"].tolist())) == 2
        assert d["het-pp"]["max_abs_err"] <= 1e-5
        assert d["pp"]["forward_err"] <= 1e-5 and d["pp"]["grad_err"] <= 1e-5
        np.testing.assert_allclose(d["slice"]["loss"], one, rtol=1e-6)
        assert d["slice"]["mesh"] == {"slice": 2, "data": 2, "model": 1}
        assert d["serve-float32"]["transports"]["all_gather"] == \
            "gloo, CPU tensors"


def test_moe_data_parallel_routes_the_global_batch(world):
    """A MoE TimeSformer over (data 2, model 1), tokens dropped: its
    routing group, capacity, slots and load-balance loss are the global
    batch's, so the step is JAX's one-device step (loss rtol 1e-5, every
    parameter 1e-4). Routing each rank's rows alone drops other tokens."""
    ref = world["jax_ts"]["ts_moe"]
    for r in world["ranks"][:2]:
        moe = r["moe_dp"]
        assert moe["dropped"] > 0
        np.testing.assert_allclose(moe["loss"], ref["loss"], rtol=1e-5)
        assert moe["state"] == world["ranks"][0]["moe_dp"]["state"]
    ratio, worst = world["checks"]["moe_dp_vs_jax"]
    assert ratio <= 1, (worst, ratio)


@pytest.mark.parametrize("phase,ref", [("sp", "ts_dense"), ("ep", "ts_moe"),
                                       ("composed", "ts_moe")])
def test_sequence_and_expert_parallel_steps_match_jax(world, phase, ref):
    """The dry run's sp (dense TimeSformer, token dims over model), ep
    (4 experts, 2 a rank at rest and in compute) and composed (fsdp + sp +
    ep) phases over the (2, 2) world: each rank's loss is JAX's one-device
    step's (rtol 1e-5) and the final state every parameter within 1e-4."""
    want = world["jax_ts"][ref]
    for r in world["ranks"]:
        got = r["dryrun"][f"{phase}-float32"]
        np.testing.assert_allclose(got["losses"], [want["loss"]], rtol=1e-5)
        assert got["model_split"]
        # the spatial attention's rows: 4 clips a data rank, by T/2 frames
        # under sp, all 4 frames without
        assert got["attention_rows"] == (8 if phase != "ep" else 16)
        if phase != "ep":
            assert got["sp_applied"]
            assert got["collective_calls"]["all_to_all"] > 0
        if phase != "sp":
            assert got["experts_held"] == {"rest": 2, "compute": 2}
            assert got["dropped"][0] > 0
    ratio, worst = world["checks"][f"{phase}_vs_jax"]
    assert ratio <= 1, (worst, ratio)


def test_timesformer_dp_with_dropout_equals_one_process(world):
    """TimeSformer over a data pair with dropout 0.3 and drop-path 0.2
    (``RowDraw`` masks, no TypeError): the one-process step, every leaf
    within 1e-6."""
    one = world["one"]["ts_dropout"]
    for r in world["ranks"][2:]:
        np.testing.assert_allclose(r["ts_dropout"]["loss"], one["loss"],
                                   rtol=1e-6)
    assert world["ranks"][3]["ts_dropout"]["state"] == \
        world["ranks"][2]["ts_dropout"]["state"]
    ratio, worst = world["checks"]["ts_dropout_vs_one"]
    assert ratio <= 1, (worst, ratio)


def test_remat_step_equals_no_remat_over_two_ranks(world):
    """TSM-R18, every BN live, global-batch BN over a data pair: with
    ``remat`` the two steps' losses, parameters and running statistics
    are those without (the statistics move once a step; BN's cross-rank
    sums run again in the recompute)."""
    for r in world["ranks"][2:]:
        np.testing.assert_allclose(r["remat"]["losses"],
                                   world["ranks"][0]["live_losses"],
                                   rtol=1e-6)
        assert r["remat"]["state_vs_live"][0] <= 1, r["remat"]


def test_model_sharded_engine_equals_one_shot(world):
    """The dry run's model-serve phase: an engine over (data 2, model 2)
    holds 1/2 of each leaf the model axis shards at rest and gives the
    one-shot engine's logits (1e-5), count and state walk."""
    for r in world["ranks"]:
        e = r["dryrun"]["model-serve-float32"]
        assert e["max_abs_err"] <= 1e-5
        assert e["count"] == e["ref_count"]
        np.testing.assert_array_equal(e["states"], e["ref_states"])
        assert e["held"] and set(e["held"].values()) == {0.5}


def test_remat_matches_no_remat_in_logits_grads_and_statistics(world):
    """TSM-R18 in train mode, every BN live (a rank of the world, one
    process): with ``remat`` the logits, every gradient and the running
    statistics are those without, and the statistics moved once (JAX
    ``test_parallel_extra.py:73``)."""
    gaps = world["ranks"][3]["remat_unit"]
    assert gaps == {"logits": 0.0, "grads": 0.0, "buffers": 0.0,
                    "moved": True}
