"""PyTorch port, the image models: ``ImageClassifier`` over the ResNet,
ConvNeXt and ViT zoos, the rank-4 engine, one ``lit_img.yaml`` train
step, the timm / HuggingFace checkpoint ports and a rank-4 export,
against the JAX package on the CPU in fp32.

Inputs come from numpy seeds; the port and the JAX model take the same
numpy-seeded flax variables. Bounds: logits and features 1e-4 (fp32
through either stack, sums in different orders); a train step's loss
1e-5 and its updated parameters and statistics 1e-4 (the slice-2 bar);
ported checkpoint trees equal to the JAX package's ports exactly, and
their logits within 1e-4 of the torch models that wrote them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_export import op_calls
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.models import convert as jconvert
from workoutdetector_tpu.models import resnet as jresnet
from workoutdetector_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from workoutdetector_tpu.models.factory import \
    ImageClassifier as JaxImageClassifier
from workoutdetector_tpu.models.timesformer import \
    TimeSformer as JaxTimeSformer
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.scripts.torch_convnext import TorchConvNeXt
from workoutdetector_tpu.scripts.torch_vit import TorchViT
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             engine_from_checkpoint)
from workoutdetector_tpu_torch.models import (ImageClassifier,
                                              TimeSformer, build_model,
                                              example_input_shape,
                                              init_flax_variables,
                                              load_flax_variables,
                                              port_convnext_checkpoint,
                                              port_timesformer_checkpoint,
                                              port_vit_checkpoint)
from workoutdetector_tpu_torch.models import convnext as convnext_mod
from workoutdetector_tpu_torch.models import timesformer as timesformer_mod
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
from workoutdetector_tpu_torch.train.trainer import Trainer
from workoutdetector_tpu_torch.utils import export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIT_IMG = os.path.join(REPO, "workoutdetector_tpu", "configs", "lit_img.yaml")
SIZE, NCLS = 32, 3
BACKBONES = ["resnet18", "resnet50", "convnext_atto", "vit_tiny_patch16_224"]
# narrow timm-layout models for the checkpoint ports
CX_TINY = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128))
VIT_MICRO = "vit_micro_patch8_224"  # (64, 2, 2), patch 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: one intra-op thread, so the parallel test workers do
    not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3),
                                                np.uint8)


def _jax_vars(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _port_logits(model, images_u8):
    with torch.no_grad():
        return model(normalize_clip(torch.from_numpy(images_u8))).numpy()


# ------------------------------------------------------- the classifiers

@pytest.mark.parametrize("base", BACKBONES)
def test_image_classifier_and_rank4_engine_match_jax(base):
    """Each zoo's logits within 1e-4 of JAX ``ImageClassifier`` on the same
    variables (ResNet-50 through the fused bottleneck's plain version),
    as (B, H, W, C) images and as (B, 1, H, W, C) clips, and through
    ``score_images`` with N below and above ``window_batch``."""
    model = ImageClassifier(base, NCLS, image_size=SIZE)
    variables = random_flax_variables(model, seed=1)
    load_flax_variables(model, variables)
    jmodel = JaxImageClassifier(base_model=base, num_class=NCLS,
                                dtype=jnp.float32)
    u8 = _images(11)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, j_normalize(x)))(
        _jax_vars(variables), jnp.asarray(u8)))
    assert want.shape == (11, NCLS) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(_port_logits(model, u8), want, atol=1e-4,
                               rtol=0)
    clips = normalize_clip(torch.from_numpy(u8[:, None]))
    with torch.no_grad():
        np.testing.assert_allclose(model(clips).numpy(), want, atol=1e-4,
                                   rtol=0)
    engine = InferenceEngine(model, window_batch=4, image_size=SIZE,
                             device="cpu", input_rank=4)
    for n in (3, 11):  # one padded batch; two full ones and a padded tail
        got = engine.score_images(u8[:n])
        assert got.shape == (n, NCLS) and got.dtype == np.float32
        np.testing.assert_allclose(got, want[:n], atol=1e-4, rtol=0)


def test_headless_resnet18_features_match_jax():
    """``num_class=0``: the pooled (N, 512) features of JAX
    ``resnet18(num_classes=0)`` within 1e-4, through a rank-4 engine."""
    model = ImageClassifier("resnet18", 0, fused_block=False)
    assert model.num_class == 512
    variables = random_flax_variables(model, seed=2)
    load_flax_variables(model, variables)
    jnet = jresnet.resnet18(num_classes=0, dtype=jnp.float32)
    jvars = {c: variables[c]["backbone_img"] for c in variables}
    u8 = _images(9, seed=3)
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, j_normalize(x)))(
        _jax_vars(jvars), jnp.asarray(u8)))
    engine = InferenceEngine(model, window_batch=4, image_size=SIZE,
                             device="cpu", input_rank=4)
    got = engine.score_images(u8)
    assert got.shape == (9, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("base", ["resnet50", "convnext_atto",
                                  "vit_tiny_patch16_224"])
def test_init_flax_variables_cover_every_zoo(base):
    """``init_flax_variables`` of each zoo gives the JAX init's tree (paths
    and shapes, from ``jax.eval_shape``) with flax's constant inits (BN and
    LayerNorm scale 1, biases 0, running var 1, ConvNeXt's γ 1e-6) and
    the ViT head's normal(0.02); the zoos' variant tables are the JAX
    package's."""
    from workoutdetector_tpu.models.convnext import \
        CONVNEXT_VARIANTS as J_CX
    from workoutdetector_tpu.models.timesformer import VIT_VARIANTS as J_VIT
    assert convnext_mod.CONVNEXT_VARIANTS == J_CX
    assert timesformer_mod.VIT_VARIANTS == J_VIT
    model = ImageClassifier(base, NCLS, image_size=SIZE)
    tree = init_flax_variables(model, seed=0)
    jmodel = JaxImageClassifier(base_model=base, num_class=NCLS)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    want = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        {c: dict(shapes[c]) for c in shapes})))
    got = dict(_leaves(tree))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for path, a in got.items():
        if path[-1] in ("scale", "var"):
            assert (a == 1).all(), path
        elif path[-1] in ("bias", "mean"):
            assert (a == 0).all(), path
        elif path[-1] == "gamma":
            assert (a == np.float32(1e-6)).all(), path
    if base.startswith("vit_"):
        head = got[("params", "backbone_img", "fc", "kernel")]
        assert abs(float(head.std()) - 0.02) < 0.004


def test_build_model_image_and_its_refusals():
    """``model_type: image`` builds each zoo from lit_img.yaml (the ViT's
    patch grid at ``model.image_size``), refuses an unknown backbone with
    KeyError as JAX ``build_model`` does, and gives rank-4 example input;
    the other families of the config build too: RepNet (an unknown
    backbone name takes its ``base`` variant, as in the JAX factory) and a
    TimeSformer with MoE MLPs."""
    for base, kind in (("resnet50", "ResNet"), ("convnext_tiny", "ConvNeXt"),
                       ("vit_base_patch32_224", "TimeSformer")):
        cfg = load_config(LIT_IMG, [f"model.base_model={base}"])
        model = build_model(cfg.model)
        assert isinstance(model, ImageClassifier)
        assert type(model.backbone_img).__name__ == kind
        assert model.num_class == 2 and model.dtype == torch.bfloat16
        assert example_input_shape(cfg.model, batch=4, image_size=64) == \
            ((4, 224, 224, 3) if kind == "TimeSformer" else (4, 64, 64, 3))
    assert model.backbone_img.patch_size == 32
    assert model.backbone_img.pos_embed.shape == (1, 50, 768)
    cfg = load_config(LIT_IMG, ["model.base_model=resnet50"])
    blocks = [m for m in build_model(cfg.model).modules()
              if type(m).__name__ == "Bottleneck"]
    assert [b.fuse for b in blocks] == [True] * 3 + [False, True, True,
                                                     True] + [False] * 9
    cfg.model.fused_block = "false"
    assert not any(m.fuse for m in build_model(cfg.model).modules()
                   if type(m).__name__ == "Bottleneck")
    cfg.model.base_model = "efficientnet_b0"
    with pytest.raises(KeyError, match="efficientnet_b0"):
        build_model(cfg.model)
    cfg.model.model_type = "repnet"
    assert type(build_model(cfg.model)).__name__ == "RepNet"
    ts = load_config(os.path.join(REPO, "workoutdetector_tpu", "configs",
                                  "timesformer.yaml"),
                     ["model.moe_experts=4", "model.base_model=custom",
                      "model.embed_dims=64", "model.num_layers=1",
                      "model.num_heads=2"])
    assert type(build_model(ts.model).block_0.mlp).__name__ == "MoEMlp"


def test_engine_from_checkpoint_takes_rank_4_for_images(tmp_path):
    """An image config's engine is rank 4 by default, scores images and
    nothing else; rank 4 is the image models' alone."""
    cfg = load_config(LIT_IMG, ["model.base_model=resnet18",
                                "model.dtype=float32", "data.image_size=32"])
    eng = engine_from_checkpoint(cfg, None, image_size=SIZE, window_batch=4,
                                 device="cpu")
    assert eng.input_rank == 4
    assert eng.score_images(_images(5)).shape == (5, 2)
    with pytest.raises(ValueError, match="rank-4"):
        eng.score_video(np.zeros((16, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError, match="rank 4"):
        engine_from_checkpoint(cfg, None, input_rank=5, device="cpu")
    cfg.model.model_type = "tsm"
    with pytest.raises(ValueError, match="rank 4"):
        engine_from_checkpoint(cfg, None, input_rank=4, device="cpu")
    with pytest.raises(ValueError, match="rank-4"):
        engine_from_checkpoint(cfg, None, image_size=SIZE, window_batch=2,
                               device="cpu").score_images(_images(2))


# ------------------------------------------------------------- training

def _lit_img(cls, opts=()):
    return cls(LIT_IMG, ["model.base_model=resnet18", "model.dtype=float32",
                         "data.image_size=32", "optimizer.lr=0.001"]
               + list(opts))


def test_image_train_step_matches_jax():
    """From identical weights and batch, one step of the port's trainer on
    lit_img.yaml (ResNet-18 image classifier, AdamW, cosine, no TSN
    policies, BN batch statistics; lr 1e-3 so the update shows at the bar)
    against the JAX train step on (B, 1, H, W, C) image clips: the loss
    within 1e-5, the gradients within 1e-4 of each leaf's largest, and the
    updated parameters and statistics within 1e-4. AdamW's first update
    is ±lr for every gradient well above its eps, so a gradient entry
    within rounding of zero (an 11M-parameter model has some) may take the
    other sign in either stack: the port's optimizer is given the JAX
    step's gradients, captured as the trainer calls it, so the update is
    held on equal inputs and the gradients on their own bar."""
    jcfg = _lit_img(j_load_config)
    model = ImageClassifier("resnet18", 2)
    variables = random_flax_variables(model, seed=4)
    jmodel = JaxImageClassifier(base_model="resnet18", num_class=2,
                                dtype=jnp.float32)
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler,
                              variables["params"], 10,
                              jcfg.trainer.max_epochs, partial_bn=False,
                              fc_lr5=True)
    rng = np.random.default_rng(5)
    x_u8 = rng.integers(0, 256, (6, 1, SIZE, SIZE, 3), dtype=np.uint8)
    y = np.array([0, 1, 1, 0, 1, 0], np.int32)

    @jax.jit
    def step(params, stats, xb, yb):
        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": stats},
                                    j_normalize(xb), train=True,
                                    mutable=["batch_stats"])
            return cross_entropy_loss(out, yb), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), new_stats, loss, grads

    jv = _jax_vars(variables)
    new_params, new_stats, want_loss, jgrads = step(
        jv["params"], jv["batch_stats"], jnp.asarray(x_u8), jnp.asarray(y))
    jgrads = flax_to_port_state({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    trainer = Trainer(_lit_img(load_config), device="cpu")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    grads = {}
    optimizer_step = state.optimizer.step

    def step_on_jax_grads():
        for n, p in state.model.named_parameters():
            grads[n] = p.grad.numpy().copy()
            p.grad = torch.from_numpy(jgrads[n].copy())  # clipped in place
        return optimizer_step()

    state.optimizer.step = step_on_jax_grads
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - float(want_loss)) <= 1e-5
    assert grads.keys() == jgrads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], rtol=0, err_msg=n,
                                   atol=1e-4 * np.abs(jgrads[n]).max())
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(
        np.asarray, {"params": new_params, "batch_stats": new_stats}))
    before = flax_to_port_state(variables)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        assert not np.array_equal(ref[k], before[k]), k  # every leaf moved


def test_lit_img_fit_from_image_files(tmp_path):
    """lit_img.yaml end to end on the CPU: ImageDataset over written JPEGs
    (one class dark, one bright), Trainer.fit for two epochs, validation
    on the inference path; the checkpoint loads into a rank-4 engine."""
    import cv2
    root = tmp_path / "img"
    root.mkdir()
    rng = np.random.default_rng(6)
    lines = []
    for i in range(24):
        label = i % 2
        img = np.clip(rng.normal(60 + 140 * label, 20, (40, 48, 3)), 0,
                      255).astype(np.uint8)
        cv2.imwrite(str(root / f"{i}.jpg"), img)
        lines.append(f"{i}.jpg {label}")
    (root / "train.txt").write_text("\n".join(lines[:16]) + "\n")
    (root / "val.txt").write_text("\n".join(lines[16:]) + "\n")
    cfg = load_config(LIT_IMG, [
        f"data.data_root={root}", f"data.train.anno={root}/train.txt",
        f"data.val.anno={root}/val.txt", f"data.test.anno={root}/val.txt",
        "model.base_model=resnet18", "model.dtype=float32",
        "data.image_size=32", "data.scale_size=40", "data.batch_size=8",
        "data.num_workers=2", "trainer.max_epochs=2", "optimizer.lr=0.003",
        "log.tensorboard_enable=false",
        f"trainer.default_root_dir={tmp_path / 'runs'}",
        f"callbacks.modelcheckpoint.dirpath={tmp_path / 'ckpt'}"])
    trainer = Trainer(cfg, device="cpu")
    state, history = trainer.fit()
    assert state.step == 4 and np.isfinite(history["val/loss"])
    eng = engine_from_checkpoint(cfg, str(tmp_path / "ckpt" / "last"),
                                 image_size=SIZE, device="cpu")
    val = np.stack([cv2.imread(str(root / f"{i}.jpg"))[4:36, 8:40, ::-1]
                    for i in range(16, 24)])
    assert eng.score_images(val).shape == (8, 2)


# ------------------------------------------------------ checkpoint ports

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


def _nchw(x):
    return torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())


def test_convnext_checkpoint_port(monkeypatch):
    """A timm-layout ConvNeXt state dict (γ ≠ 1e-6) through
    ``port_convnext_checkpoint`` into an ``ImageClassifier``: the JAX
    port's tree exactly, logits within 1e-4 of the torch model and of the
    JAX model on the JAX port; a 1000-class head is dropped."""
    monkeypatch.setitem(convnext_mod.CONVNEXT_VARIANTS, "convnext_micro",
                        (CX_TINY["depths"], CX_TINY["dims"]))
    torch.manual_seed(0)
    tmodel = TorchConvNeXt(num_classes=7, **CX_TINY).eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(getattr(m, "gamma", None), torch.nn.Parameter):
                m.gamma.uniform_(0.5, 1.5)
    sd = tmodel.state_dict()
    tree = port_convnext_checkpoint(sd, 7, prefix=("backbone_img",))
    _same_tree(tree, jconvert.port_convnext_checkpoint(
        sd, 7, prefix=("backbone_img",)))
    model = ImageClassifier("convnext_micro", 7)
    load_flax_variables(model, tree)
    x = np.random.default_rng(7).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        want = tmodel(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jtree = jconvert.port_convnext_checkpoint(sd, 7)
    jnet = JaxConvNeXt(num_classes=7, **CX_TINY)
    jout = jax.jit(jnet.apply)({"params": jtree["params"]}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(jout), atol=1e-4, rtol=1e-4)
    big = TorchConvNeXt(num_classes=1000, **CX_TINY).state_dict()
    assert "head" not in port_convnext_checkpoint(big, 7)["params"]
    # the depthwise kernel: (C, 1, 7, 7) OIHW ↔ (7, 7, 1, C) HWIO
    assert tree["params"]["backbone_img"]["stage0_block0"]["conv_dw"][
        "kernel"].shape == (7, 7, 1, 16)
    assert model.backbone_img.stage0_block0.conv_dw.weight.shape == \
        (16, 1, 7, 7)


def test_vit_checkpoint_port(monkeypatch):
    """A timm-layout ViT state dict through ``port_vit_checkpoint`` into the
    ``ImageClassifier``'s ViT branch: the JAX port's tree exactly, logits
    within 1e-4 of the torch model and of JAX ``ImageClassifier``."""
    monkeypatch.setitem(timesformer_mod.VIT_VARIANTS, VIT_MICRO, (64, 2, 2))
    torch.manual_seed(1)
    tmodel = TorchViT(image_size=SIZE, patch=8, dim=64, depth=2, heads=2,
                      num_classes=7).eval()
    sd = tmodel.state_dict()
    tree = port_vit_checkpoint(sd, 7)
    _same_tree(tree, jconvert.port_vit_checkpoint(sd, 7))
    model = ImageClassifier(VIT_MICRO, 7, image_size=SIZE)
    load_flax_variables(model, tree)
    x = np.random.default_rng(8).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        want = tmodel(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jnet = JaxTimeSformer(num_class=7, num_segments=1, patch_size=8,
                          embed_dims=64, num_layers=2, num_heads=2,
                          attention_type="space_only", dtype=jnp.float32)
    jout = jax.jit(jnet.apply)({"params": tree["params"]["backbone_img"]},
                               jnp.asarray(x[:, None]))
    np.testing.assert_allclose(got, np.asarray(jout), atol=1e-4, rtol=1e-4)
    big = TorchViT(image_size=SIZE, patch=8, dim=64, depth=2, heads=2,
                   num_classes=1000).state_dict()
    assert "fc" not in port_vit_checkpoint(big, 7)["params"]["backbone_img"]


# a TimeSformer block's modules: port name → (HuggingFace, mmaction) names
_TS_BLOCK = {
    "t_norm": ("temporal_layernorm", "attentions.0.norm"),
    "t_attn.proj": ("temporal_attention.output.dense",
                    "attentions.0.attn.out_proj"),
    "t_fc": ("temporal_dense", "attentions.0.temporal_fc"),
    "s_norm": ("layernorm_before", "attentions.1.norm"),
    "s_attn.proj": ("attention.output.dense", "attentions.1.attn.out_proj"),
    "mlp_norm": ("layernorm_after", "ffns.0.norm"),
    "mlp.fc1": ("intermediate.dense", "ffns.0.layers.0.0"),
    "mlp.fc2": ("output.dense", "ffns.0.layers.1"),
}
_TS_TOP = {  # port name → (HuggingFace, mmaction) names
    "cls_token": ("timesformer.embeddings.cls_token", "backbone.cls_token"),
    "pos_embed": ("timesformer.embeddings.position_embeddings",
                  "backbone.pos_embed"),
    "time_embed": ("timesformer.embeddings.time_embeddings",
                   "backbone.time_embed"),
    "patch_embed": ("timesformer.embeddings.patch_embeddings.projection",
                    "backbone.patch_embed.projection"),
    "norm": ("timesformer.layernorm", "backbone.norm"),
    "fc": ("classifier", "cls_head.fc_cls"),
}


def _timesformer_state_dict(state, layout):
    """A port TimeSformer's state dict under HuggingFace's (0) or
    mmaction's (1) key names (both hold torch's (out, in) and OIHW
    layouts, as the port does)."""
    out = {}
    for key, v in state.items():
        if "." not in key:  # the embeddings
            out[_TS_TOP[key][layout]] = v
            continue
        mod, leaf = key.rsplit(".", 1)
        if mod.startswith("block_"):
            i, sub = mod[len("block_"):].split(".", 1)
            if sub.endswith("attn.qkv"):
                hf = ("temporal_attention" if sub[0] == "t" else
                      "attention") + f".attention.qkv.{leaf}"
                mm = f"attentions.{int(sub[0] == 's')}.attn.in_proj_{leaf}"
                name = (hf, mm)[layout]
            else:
                name = f"{_TS_BLOCK[sub][layout]}.{leaf}"
            prefix = ("timesformer.encoder.layer.",
                      "backbone.transformer_layers.layers.")[layout]
            out[f"{prefix}{i}.{name}"] = v
        else:
            out[f"{_TS_TOP[mod][layout]}.{leaf}"] = v
    return out


def test_timesformer_checkpoint_port():
    """HuggingFace- and mmaction-layout TimeSformer state dicts (written
    from a numpy-seeded port model) through
    ``port_timesformer_checkpoint``: the JAX port's trees exactly, and a
    model loaded from them gives the writer's logits; a head of another
    width is dropped."""
    src = TimeSformer(5, 4, SIZE, 8, 64, 2, 2)
    load_flax_variables(src, random_flax_variables(src, seed=11))
    state = {k: v.clone() for k, v in src.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 4, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        want = src(x).numpy()
    init = init_flax_variables(src, seed=0)
    for layout in (0, 1):
        sd = _timesformer_state_dict(state, layout)
        tree = port_timesformer_checkpoint(sd, 5,
                                           target_params=init["params"])
        _same_tree(tree, jconvert.port_timesformer_checkpoint(
            sd, 5, target_params=init["params"]))
        model = TimeSformer(5, 4, SIZE, 8, 64, 2, 2)
        load_flax_variables(model, {"params": tree["params"],
                                    "batch_stats": {}})
        with torch.no_grad():
            np.testing.assert_array_equal(model(x).numpy(), want)
    assert "fc" not in port_timesformer_checkpoint(
        _timesformer_state_dict(state, 0), 6)["params"]


# --------------------------------------------------------------- export

def test_image_artifact_round_trip(tmp_path):
    """A rank-4 ``.pt2`` of an image ResNet-50 on the CPU: its graph calls
    the 6 ``wd::fused_bottleneck`` ops a live forward launches on the
    card, it loads back through ``from_exported`` (rank 4, one segment)
    and scores as the live engine, through ``scripts/export_model`` too."""
    model = ImageClassifier("resnet50", NCLS, image_size=SIZE)
    load_flax_variables(model, random_flax_variables(model, seed=9))
    path = export.export_model(model, str(tmp_path / "img"), (4, SIZE, SIZE, 3),
                               device="cpu")
    eng = InferenceEngine.from_exported(path, device="cpu")
    assert op_calls(eng._exported.program) == {"fused_bottleneck": 6}
    assert (eng.input_rank, eng.num_segments, eng.window_batch,
            eng.image_size, eng.num_class) == (4, 1, 4, SIZE, NCLS)
    live = InferenceEngine(model, window_batch=4, image_size=SIZE,
                           device="cpu", input_rank=4)
    u8 = _images(6, seed=10)
    np.testing.assert_allclose(eng.score_images(u8), live.score_images(u8),
                               atol=1e-5, rtol=0)
    from workoutdetector_tpu_torch.scripts import export_model as cli
    cli.main(["--cpu", "-o", str(tmp_path / "cli"), "--batch", "2", "--cfg",
              LIT_IMG, "model.base_model=resnet18",
              "model.dtype=float32", "data.image_size=32"])
    art = engine_from_checkpoint(None, str(tmp_path / "cli.pt2"),
                                 device="cpu")
    assert art.input_rank == 4 and art.meta["model_type"] == "image"
    assert art.score_images(u8).shape == (6, 2)
