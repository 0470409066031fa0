"""PyTorch port, TimeSformer: the attention's plain version, the blocks,
the whole model, the t_fc fold and the engine against the JAX package,
fp32 on the CPU, on the same numpy-seeded inputs and flax variables.

Tolerances: attention and blocks 1e-5, logits 1e-4 (the repo's torch↔JAX
bar), fold parameters 1e-6; argmax sequences and counts identical. The
JAX side runs jitted at the narrow widths of ``tests/test_timesformer.py``
(B 2, T 4, 32 px, patch 8, D 64, 2 layers) with 2 heads, so the head
width is 32. Where the JAX function reaches the library Pallas TPU flash
attention (``_flash_mha``, ``flash_attention=True``) it runs in interpret
mode: a few calls, each several seconds.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from workoutdetector_tpu import counting as jcounting
from workoutdetector_tpu.data.video import VideoReader
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import count_by_video_model as j_count
from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             count_by_video_model)
from workoutdetector_tpu_torch.models import (TimeSformer, build_model,
                                              fold_for_inference,
                                              fold_timesformer_tfc,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models import timesformer as tts
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.ops import kernels

B, T, SIZE, PATCH, DIM, LAYERS, HEADS, NCLS = 2, 4, 32, 8, 64, 2, 2, 5
TYPES = ["divided_space_time", "joint_space_time", "space_only"]
YAML = str(Path(__file__).resolve().parents[1]
           / "workoutdetector_tpu/configs/timesformer.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(attention_type="divided_space_time", **kw):
    return TimeSformer(NCLS, T, SIZE, PATCH, DIM, LAYERS, HEADS,
                       attention_type=attention_type, **kw)


def _jax(attention_type="divided_space_time", **kw):
    return jts.TimeSformer(num_class=NCLS, num_segments=T, image_size=SIZE,
                           patch_size=PATCH, embed_dims=DIM,
                           num_layers=LAYERS, num_heads=HEADS,
                           attention_type=attention_type, dtype=jnp.float32,
                           **kw)


def _jax_params(variables):
    return {"params": jax.tree_util.tree_map(jnp.asarray,
                                             variables["params"])}


def _apply(module, variables, *args):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a))(
        _jax_params(variables), *(jnp.asarray(a) for a in args)))


def _clips(seed=0, n=B):
    return np.random.default_rng(seed).normal(
        size=(n, T, SIZE, SIZE, 3)).astype(np.float32)


def _qkv(l, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 2, l, 32)).astype(np.float32)
            for _ in range(3)]


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("l", [5, 17, 197])
def test_attention_plain_matches_the_tpu_flash_kernel(l):
    """The port's plain attention against the library Pallas TPU flash
    kernel itself (``_flash_mha``: 128-padding, segment-id masking), run
    in interpret mode."""
    q, k, v = _qkv(l, l)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jts._flash_mha, static_argnums=3)(
            *(jnp.asarray(a) for a in (q, k, v)), 32 ** -0.5))
    got = kernels.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  32 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("l", [5, 17, 197])
def test_attention_wrapper_matches_the_xla_path(l):
    """The wrapper on CPU tensors (its plain version) against the JAX
    package's XLA attention (softmax(q kᵀ · scale) v)."""
    q, k, v = _qkv(l, 100 + l)
    s = jnp.asarray(q) @ jnp.asarray(k).transpose(0, 1, 3, 2) * 32 ** -0.5
    want = np.asarray(jax.nn.softmax(s, axis=-1) @ jnp.asarray(v))
    before = kernels.attention.launches
    got = kernels.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            32 ** -0.5)
    assert kernels.attention.launches == before  # CPU: no kernel launched
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("flash", [False, True])
def test_mha_matches_flax(flash):
    port = tts.MHA(DIM, HEADS, flash=flash)
    variables = random_flax_variables(port, seed=1)
    load_flax_variables(port, variables)
    x = np.random.default_rng(2).normal(size=(3, 11, DIM)).astype(np.float32)
    want = _apply(jts.MHA(DIM, HEADS), variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("folded", [False, True])
def test_divided_block_matches_flax(folded):
    port = tts.DividedBlock(DIM, HEADS, flash=True,
                            fold_temporal_fc=folded)
    variables = random_flax_variables(port, seed=3)
    load_flax_variables(port, variables)
    rng = np.random.default_rng(4)
    cls = rng.normal(size=(B, 1, DIM)).astype(np.float32)
    patches = rng.normal(size=(B, 16, T, DIM)).astype(np.float32)
    jblock = jts.DividedBlock(DIM, HEADS, fold_temporal_fc=folded)
    want_cls, want_pat = jax.jit(lambda v, c, p: jblock.apply(v, c, p))(
        _jax_params(variables), jnp.asarray(cls), jnp.asarray(patches))
    with torch.no_grad():
        got_cls, got_pat = port(torch.from_numpy(cls),
                                torch.from_numpy(patches))
    np.testing.assert_allclose(got_cls.numpy(), want_cls, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_pat.numpy(), want_pat, rtol=1e-5,
                               atol=1e-5)


def test_joint_block_matches_flax():
    port = tts.JointBlock(DIM, HEADS)
    variables = random_flax_variables(port, seed=5)
    load_flax_variables(port, variables)
    x = np.random.default_rng(6).normal(size=(B, 33, DIM)).astype(np.float32)
    want = _apply(jts.JointBlock(DIM, HEADS), variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("attention_type", TYPES)
def test_random_tree_has_the_jax_init_structure(attention_type):
    """The port's variable tree (names, shapes) is the JAX model's."""
    port = _port(attention_type)
    tree = random_flax_variables(port, seed=0)
    shapes = jax.eval_shape(lambda: _jax(attention_type).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, T, SIZE, SIZE, 3)), train=False))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  dict(shapes["params"])) == \
        jax.tree_util.tree_map(lambda a: a.shape, tree["params"])
    assert not tree["batch_stats"]


@pytest.mark.parametrize("case", TYPES + ["divided_space_time+flash"])
def test_timesformer_logits_match_jax(case):
    """Logits of the port (its main path: the attention wrapper, plain on
    the CPU) against the JAX model; the '+flash' case runs the JAX model
    through the Pallas TPU flash kernel in interpret mode."""
    attention_type, _, flash = case.partition("+")
    port = _port(attention_type)
    variables = random_flax_variables(port, seed=7)
    load_flax_variables(port, variables)
    x = _clips(8)
    if flash:
        with pltpu.force_tpu_interpret_mode():
            want = _apply(_jax(attention_type, flash_attention=True),
                          variables, x)
    else:
        want = _apply(_jax(attention_type), variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, NCLS)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_logits_are_fp32_and_close():
    port = _port(dtype=torch.bfloat16)
    ref = _port()
    variables = random_flax_variables(port, seed=9)
    load_flax_variables(port, variables)
    load_flax_variables(ref, variables)
    x = torch.from_numpy(_clips(10))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 0.05 * (1 + want.abs().max())


# ---------------------------------------------------------------- fold
def test_random_tree_has_a_nonzero_t_fc():
    tree = random_flax_variables(_port(), seed=0)["params"]
    for i in range(LAYERS):
        tfc = tree[f"block_{i}"]["t_fc"]
        assert np.count_nonzero(tfc["kernel"]) == tfc["kernel"].size
        assert np.abs(tfc["kernel"]).max() > 0.05
        assert np.abs(tfc["bias"]).max() > 0.01


def test_fold_parameters_match_the_jax_fold():
    port = _port()
    variables = random_flax_variables(port, seed=11)
    load_flax_variables(port, variables)
    jfolded = jts.fold_timesformer_tfc(_jax_params(variables)["params"])
    want = flax_to_port_state({"params": jax.tree_util.tree_map(
        np.asarray, jfolded)})
    folded = fold_for_inference(port)
    got = folded.state_dict()
    assert sorted(got) == sorted(want)
    assert not any(".t_fc." in k for k in got)
    for key, a in want.items():
        np.testing.assert_allclose(got[key].numpy(), a, rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    # the numpy fold on the flax tree gives the same tree
    np_folded = fold_timesformer_tfc(variables["params"])
    for key, a in flax_to_port_state({"params": np_folded}).items():
        np.testing.assert_allclose(a, want[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    # the model itself is untouched
    assert hasattr(port.block_0, "t_fc") and not port.fold_temporal_fc


def test_folded_logits_equal_unfolded_and_jax_folded():
    port = _port()
    variables = random_flax_variables(port, seed=12)
    load_flax_variables(port, variables)
    folded = fold_for_inference(port)
    assert folded.fold_temporal_fc and folded is not port
    x = _clips(13)
    with torch.no_grad():
        a = port(torch.from_numpy(x)).numpy()
        b = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    jmodel, jvars = jts.fold_for_inference(_jax(), _jax_params(variables))
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x))(
        jvars, jnp.asarray(x)))
    np.testing.assert_allclose(b, want, rtol=1e-4, atol=1e-4)


def test_fold_leaves_other_models_alone():
    joint = _port("joint_space_time")
    assert fold_for_inference(joint) is joint
    folded = fold_for_inference(_port())
    assert fold_for_inference(folded) is folded
    from workoutdetector_tpu_torch.models import TSM
    tsm = TSM(3, 4, "resnet18")
    assert fold_for_inference(tsm) is tsm


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    port = _port()
    variables = random_flax_variables(port, seed=14)
    load_flax_variables(port, variables)
    jengine = JaxEngine(_jax(), _jax_params(variables), num_segments=T,
                        window_batch=4, image_size=SIZE)
    tengine = InferenceEngine(port, num_segments=T, window_batch=4,
                              device="cpu")
    assert tengine.model.fold_temporal_fc  # optimize=True folded t_fc
    assert jengine.model.fold_temporal_fc
    return jengine, tengine


def _write_video(path, pattern, frames_per_state=12, wh=(96, 96)):
    import cv2
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, wh)
    for val in pattern:
        for _ in range(frames_per_state):
            frame = np.full((wh[1], wh[0], 3), val, np.uint8)
            frame[20:60, 30:70] = rng.integers(0, 256, 3, dtype=np.uint8)
            w.write(frame)
    w.release()
    return str(path)


def test_score_video_and_count_match_jax(engines, tmp_path):
    jengine, tengine = engines
    path = _write_video(tmp_path / "reps.mp4", [20, 235] * 3)  # 72 frames
    with VideoReader(path) as r:
        video = r.read_prepped(256, SIZE)
    j_starts, j_logits = jengine.score_video(video, step=4, stride=2)
    t_starts, t_logits = tengine.score_video(video, step=4, stride=2)
    np.testing.assert_array_equal(t_starts, j_starts)
    assert len(t_starts) % 4 != 0  # the zero-padded tail chunk ran
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_logits.argmax(1), j_logits.argmax(1))
    assert j_count(jengine, path) == count_by_video_model(tengine, video)


@pytest.mark.parametrize("frames", [0, 3])
def test_short_videos_match_jax(engines, frames):
    """No window (0 frames) and one window shorter than a clip."""
    jengine, tengine = engines
    video = np.random.default_rng(frames).integers(
        0, 256, (frames, SIZE, SIZE, 3), dtype=np.uint8)
    j_starts, j_logits = jengine.score_video(video, step=4, stride=2)
    t_starts, t_logits = tengine.score_video(video, step=4, stride=2)
    np.testing.assert_array_equal(t_starts, j_starts)
    assert t_logits.shape == j_logits.shape == (len(j_starts), NCLS)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    assert count_by_video_model(tengine, video) == (0, [])


def test_count_states_match_jax(engines):
    """Dense 8-frame chunks of a random video: the same per-chunk states
    and the same count through each package's pred_to_count."""
    jengine, tengine = engines
    video = np.random.default_rng(15).integers(
        0, 256, (83, SIZE, SIZE, 3), dtype=np.uint8)
    starts = np.arange(0, (len(video) // 8) * 8, 8)
    _, jl = jengine.score_video(video, stride=1, starts=starts)
    _, tl = tengine.score_video(video, stride=1, starts=starts)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    states = [int(a) for a in jl.argmax(1)]
    assert [int(a) for a in tl.argmax(1)] == states
    assert count_by_video_model(tengine, video) == \
        tuple(jcounting.pred_to_count(states, step=8))


# ---------------------------------------------------------------- factory
def test_build_model_from_the_timesformer_yaml():
    cfg = load_config(YAML)
    model = build_model(cfg.model)
    assert isinstance(model, TimeSformer)
    blocks = model.blocks()
    assert len(blocks) == 12 and model.num_class == 12
    assert model.pos_embed.shape == (1, 197, 768)
    assert blocks[0].s_attn.num_heads == 12
    assert all(b.s_attn.flash and not b.t_attn.flash for b in blocks)
    assert model.dtype == torch.bfloat16
    assert not any(b.s_attn.flash for b in
                   build_model(cfg.model, use_kernels=False).blocks())
    cfg.model.flash_attention = "false"
    assert not any(b.s_attn.flash for b in build_model(cfg.model).blocks())
    # moe_experts > 0 puts a MoEMlp in each divided block (narrowed here:
    # the expert stacks of a ViT-B/16 are 450 MB of fp32 zeros)
    m = cfg.model
    m.moe_experts, m.base_model, m.embed_dims, m.num_layers, m.num_heads = \
        4, "custom", 64, 2, 2
    mlps = [b.mlp for b in build_model(m).blocks()]
    assert [type(x).__name__ for x in mlps] == ["MoEMlp"] * 2
    assert mlps[0].num_experts == 4 and mlps[0].capacity_factor == 1.25


def test_build_model_sizes_without_a_variant():
    cfg = load_config(YAML)
    m = cfg.model
    m.base_model, m.embed_dims, m.num_layers, m.num_heads = "custom", 64, 2, 2
    m.image_size, m.patch_size, m.num_segments = SIZE, PATCH, T
    model = build_model(m)
    assert len(model.blocks()) == 2 and model.pos_embed.shape == (1, 17, 64)
    assert tts.vit_patch_size("vit_base_patch32_224") == 32
    # train mode runs, with the yaml's drop_path_rate 0.1 over the layers
    assert [b.drop_path for b in model.blocks()] == [0.0, 0.1]
    model.train()
    logits = model(torch.zeros(1, T, SIZE, SIZE, 3),
                   dropout_generator=torch.Generator().manual_seed(0))
    assert logits.shape == (1, 12) and torch.isfinite(logits).all()
