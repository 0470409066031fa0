"""PyTorch port, pipeline parallelism: ``pipeline_apply`` and
``pipeline_apply_het`` (GPipe, point to point between stage ranks) with
their gradients, the TSM and TDN segment-ranged stages, and the pp-staged
and data-sharded engines, held against the JAX package's functions on the
8-device CPU mesh.

A world of 2 gloo ranks on the CPU runs every scenario once per test
run, one stage each (``torch_parallel_ranks.pipeline_world``; the dry run
in ``test_torch_parallel.py`` composes pipelines with the data axis on 4
ranks), while the JAX references are computed (``torch_parallel_refs``).
Tolerances (fp32): forwards 1e-5, gradients rtol 1e-4 (the JAX tests'
bars between the pipelined and the sequential program; here the two
sides are also two frameworks summing in other orders).
"""

import re

import numpy as np
import pytest

from torch_parallel_refs import pipeline_results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return pipeline_results(tmp_path_factory)


def _close_trees(got, want, rtol, atol):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close_trees(got[k], want[k], rtol, atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["dense_m2", "dense_m4"])
def test_pipeline_apply_and_gradients_match_jax(world, name):
    """Homogeneous tanh stages over 2 stage ranks with 2 and 4
    microbatches: every rank's output and stacked-parameter gradients are
    the JAX pipeline's."""
    want = world["jax"][name]
    for r in world["ranks"]:
        np.testing.assert_allclose(r[name]["y"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        _close_trees(r[name]["grads"], want["grads"], 1e-4, 1e-6)


def test_het_pipeline_ragged_widths_match_jax(world):
    """16→24→6 over 2 stages, each boundary at its own width: the output
    at 4 and 2 microbatches, the parameter and input gradients (JAX's at
    2 microbatches)."""
    want = world["jax"]["het_dense"]
    for r in world["ranks"]:
        got = r["het_dense"]
        np.testing.assert_allclose(got["y4"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["y2"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        _close_trees(got["grads"], want["grads"], 1e-4, 1e-6)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"], rtol=1e-4,
                                   atol=1e-6)


def test_het_pipeline_tsm_r18_stages_match_jax(world):
    """TSM-R18 cut at layer2|layer3 ([0, 3, 6]) over 2 stage ranks: logits
    and every parameter's gradient of a CE are JAX's pipeline's."""
    want = world["jax"]["tsm"]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["tsm"]["logits"], want["logits"],
                                   rtol=1e-5, atol=1e-5)
    ratio, worst = world["checks"]["tsm_grads_vs_jax"]
    assert ratio <= 1, (worst, ratio)  # rtol 1e-4, atol 1e-5
    assert world["ranks"][1]["tsm"]["grads"] == \
        world["ranks"][0]["tsm"]["grads"]


def test_het_pipeline_tdn_stages_match_jax(world):
    """TDN-R50 cut after its stems and layer1 ([0, 2, 5]): the staged
    logits are JAX's one-shot TDN's."""
    for r in world["ranks"]:
        np.testing.assert_allclose(r["tdn"], world["jax"]["tdn"], rtol=1e-4,
                                   atol=1e-4)


def test_pp_staged_and_sharded_engines_match_one_shot(world):
    """11 windows (a full chunk of 8 and a padded tail of 3): the engine
    staged over 2 ranks (cuts [0, 3, 6] in 2 microbatches, [0, 2, 6] in
    4) and the one sharded over 2 data ranks give the one-shot engine's
    logits; a mesh engine gathers on the host."""
    for r in world["ranks"]:
        e = r["engines"]
        for k in ("pp", "pp_m4", "sharded"):
            np.testing.assert_allclose(e[k], e["one_shot"], rtol=1e-5,
                                       atol=1e-5)
        assert r["gather"] == {"one_shot": True, "pp": False, "pp_m4": False,
                               "sharded": False}


def test_validation_errors_match_jax(world):
    """The engine's pp checks (a mesh, one cut per stage, microbatches of
    the window batch, a microbatch over the data axis) raise with the JAX
    engine's messages; the pipeline refuses a batch the microbatches do
    not divide and a stage count off the axis."""
    want = world["jax"]["errors"]
    for r in world["ranks"]:
        got = r["errors"]
        for k in ("mesh", "stages", "microbatches", "data"):
            # the JAX mesh is (4, 2), the port's 2 ranks: the numbers differ
            assert re.sub(r"\d+", "N", got[k]) == \
                re.sub(r"\d+", "N", want[k]), k
        assert got["batch"] == "batch 5 not divisible by microbatches=2"
        assert got["count"] == "need 2 stages for the model=2 axis, got 1"
