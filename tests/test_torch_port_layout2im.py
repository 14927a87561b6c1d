"""The port's layout2im CVAE-GAN modules against the JAX package's, on the CPU.

- Ops at f32 round-off (1e-5 of the largest value): ``crop_boxes`` and
  ``paste_boxes``; ``MaskedBatchNorm`` in training with pad slots (output
  and running statistics, the unbiased factor from the masked count),
  without a mask and in eval; ``ConditionalBatchNorm``; the plain
  ``MultiHeadAttention`` with a key mask; a flax ``ConvTranspose(padding=
  "SAME")`` against ``ConvTranspose2d(k=4, s=2, p=1)`` through the
  converter, which flips the kernel in both spatial axes (unflipped, the
  two differ); the ConvLSTM fusion with pad steps.
- Networks at 2e-3 (the PARITY.md bar), JAX's weights converted by
  ``utils.convert.layout2im_state_dict_from_jax`` (BN statistics moved off
  0/1 for the eval forwards): the crop encoder with the VAE noise given,
  the layout encoder with each of the four fusions (``convlstm`` and
  ``transformer_decoder`` at conv_dim 8; ``transformer`` and
  ``transformer_noctx`` at the JAX package's fixed d_model 512, conv_dim
  64), the decoder, the whole generator in training mode (every output of
  the forward and the BN running statistics after it, which fold in the
  JAX forward's order) and its ``sample`` in eval, and both
  discriminators with and without spectral norm in training mode (scores
  and SN u after the call).

b=2, o=4 with pad slots, 64 px. The JAX ``Layout2ImGenerator`` has no
``conv_dim`` field (it is 64); the small generator here is a test-only
subclass that passes one to its three parts, as the port's constructor does.
"""

import functools

import numpy as np
import pytest
import torch

import jax
from flax import linen as fnn

from layout2img_tpu.models import layout2im as jl
from layout2img_tpu.models.convlstm import LayoutConvLSTM as JaxLayoutConvLSTM
from layout2img_tpu.nn.attention import MultiHeadAttention as JaxMultiHeadAttention
from layout2img_tpu.ops.bbox import bbox_mask as jax_bbox_mask
from layout2img_tpu.ops.interp import crop_boxes as jax_crop_boxes
from layout2img_tpu.ops.interp import paste_boxes as jax_paste_boxes
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.models import layout2im as pl
from layout2img_tpu_torch.models.convlstm import LayoutConvLSTM
from layout2img_tpu_torch.nn.attention import MultiHeadAttention
from layout2img_tpu_torch.ops.bbox import bbox_mask
from layout2img_tpu_torch.ops.interp import crop_boxes, paste_boxes
from layout2img_tpu_torch.utils.convert import _init_layout2im_, layout2im_state_dict_from_jax
from test_torch_port_step_knobs import _few_threads, fast_jit  # noqa: F401  (autouse)

TOL = 2e-3
B, O, Z, NC, CD = 2, 4, 8, 12, 8


class SmallJaxGenerator(jl.Layout2ImGenerator):
    """``Layout2ImGenerator`` with its parts at ``conv_dim``."""

    conv_dim: int = CD

    def setup(self):
        self.crop_encoder = jl.CropEncoder(self.num_classes, conv_dim=self.conv_dim,
                                           z_dim=self.z_dim)
        self.layout_encoder = jl.LayoutEncoder(self.num_classes, conv_dim=self.conv_dim,
                                               z_dim=self.z_dim, embedding_dim=self.embedding_dim,
                                               fusion=self.fusion)
        self.decoder = jl.Decoder(conv_dim=self.conv_dim)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rel(got, want, tol: float, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _abs(got, want, tol: float = TOL, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err)


def _nchw(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, -3)


def _moved(rng, variables: dict) -> dict:
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    return variables


def _load(module: torch.nn.Module, variables: dict, train: bool) -> torch.nn.Module:
    module.load_state_dict(layout2im_state_dict_from_jax(variables), strict=True)
    return module.train(train)


def _stats_match(module: torch.nn.Module, variables: dict, new: dict, tol: float = 1e-5) -> int:
    """The module's running statistics and SN u vectors against JAX's after
    the call; returns how many were held."""
    want = layout2im_state_dict_from_jax({**variables, **new})
    n = 0
    for k, v in module.state_dict().items():
        if k.endswith(("running_mean", "running_var", "weight_u")):
            _rel(v, want[k].numpy(), tol, k)
            n += 1
    return n


def jax_variables(module, port: torch.nn.Module, *init_args) -> dict:
    """JAX variables for ``module`` holding the port module's weights: the
    tree of ``module.init(*init_args)`` (by ``jax.eval_shape``, which
    compiles nothing) filled by the inverse of
    ``layout2im_state_dict_from_jax``."""
    template = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    spectral = template.get("spectral", {})

    def is_sn(path) -> bool:
        node = spectral
        for k in path:
            if k not in node:
                return False
            node = node[k]
        return True

    def fill(node: dict, path: tuple, coll: str) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,), coll)
                continue
            name = ".".join(path)
            key = (lambda leaf: f"{name}.{leaf}" if name else leaf)  # noqa: E731
            if coll == "spectral":
                w = sd[key("weight_u")]
            elif coll == "batch_stats":
                w = sd[key({"mean": "running_mean", "var": "running_var"}[k])]
            elif k in ("kernel", "embedding"):
                w = sd[key("weight_orig" if is_sn(path) else "weight")]
                if k == "kernel" and w.ndim == 4:
                    w = (np.flip(w.transpose(2, 3, 0, 1), (0, 1)) if path[-1].startswith("dc")
                         else w.transpose(2, 3, 1, 0))
                elif k == "kernel":
                    w = w.T
            else:
                w = sd[key("weight" if k == "scale" else k)]
            assert w.shape == v.shape, (path, k, w.shape, v.shape)
            out[k] = np.ascontiguousarray(w).astype(v.dtype)
        return out

    return {coll: fill(tree, (), coll) for coll, tree in template.items()}


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    _init_layout2im_(module, torch.Generator().manual_seed(seed))
    return module


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.1, 0.5, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(1, NC, (B, O)).astype(np.int32)
    labels[0, 3:] = 0
    labels[1, 2:] = 0
    boxes[labels == 0] = PAD_BOX
    images = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((B, O, Z)).astype(np.float32)
    masks = np.asarray(jax_bbox_mask(boxes, 64, 64))
    return dict(images=images, labels=labels, boxes=boxes, z=z, masks=masks,
                valid=(labels != 0).astype(np.float32), rng=rng)


# ---- ops ----

def test_crop_and_paste_boxes_match_jax(inputs):
    images, boxes = inputs["images"], inputs["boxes"]
    crops = crop_boxes(_t(images).permute(0, 3, 1, 2), _t(boxes), 32)
    want = np.asarray(jax_crop_boxes(images, boxes, 32))
    assert crops.shape == (B, O, 3, 32, 32)
    _rel(crops, _nchw(want), 1e-5, "crops")
    pasted = paste_boxes(crops, _t(boxes), 48, 40)
    want_p = np.asarray(jax_paste_boxes(want, boxes, 48, 40))
    assert pasted.shape == (B, O, 3, 48, 40)
    _rel(pasted, _nchw(want_p), 1e-5, "pasted")
    assert torch.equal(bbox_mask(_t(boxes), 64, 64), _t(inputs["masks"]))


@pytest.mark.parametrize("masked,train,affine", [(True, True, True), (False, True, True),
                                                 (True, False, True), (True, True, False)])
def test_masked_batch_norm_matches_jax(inputs, masked, train, affine):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((B * O, 6, 5, 5)) * 2 + 1).astype(np.float32)
    mask = inputs["valid"].reshape(-1) if masked else None
    mod = jl.MaskedBatchNorm(affine=affine)
    xh = np.moveaxis(x, 1, -1)
    variables = _moved(rng, mod.init(jax.random.PRNGKey(0), xh, mask))
    if affine:
        variables["params"] = jax.tree_util.tree_map(
            lambda p: p + rng.uniform(-0.5, 0.5, p.shape).astype(p.dtype), variables["params"])
    want, new = mod.apply(variables, xh, mask, use_running_average=not train,
                          mutable=["batch_stats"])
    port = _load(pl.MaskedBatchNorm(6, affine=affine), variables, train)
    got = port(_t(x), None if mask is None else _t(mask))
    _rel(got, _nchw(want), 1e-5, "output")
    assert _stats_match(port, variables, new) == 2


def test_conditional_batch_norm_matches_jax(inputs):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B * O, 6, 5, 5)).astype(np.float32)
    lab, mask = inputs["labels"].reshape(-1), inputs["valid"].reshape(-1)
    mod = jl.ConditionalBatchNorm(NC)
    xh = np.moveaxis(x, 1, -1)
    variables = _moved(rng, mod.init(jax.random.PRNGKey(0), xh, lab, mask))
    variables["params"]["beta"]["embedding"] = rng.standard_normal((NC, 6)).astype(np.float32)
    want, new = mod.apply(variables, xh, lab, mask, mutable=["batch_stats"])
    port = _load(pl.ConditionalBatchNorm(NC, 6), variables, True)
    _rel(port(_t(x), _t(lab).long(), _t(mask)), _nchw(want), 1e-5)
    assert _stats_match(port, variables, new) == 2


@pytest.mark.parametrize("heads,d_k", [(1, 16), (4, 8)])
def test_multi_head_attention_with_key_mask_matches_jax(inputs, heads, d_k):
    rng = np.random.default_rng(14)
    d = 16
    q = rng.standard_normal((B, 5, d)).astype(np.float32)
    kv = rng.standard_normal((B, O, d)).astype(np.float32)
    mod = JaxMultiHeadAttention(heads, d, d_k, d // heads)
    variables = jax.tree_util.tree_map(np.asarray, dict(mod.init(
        jax.random.PRNGKey(0), q, kv, kv, labels=inputs["labels"])))
    want = mod.apply(variables, q, kv, kv, labels=inputs["labels"])
    port = _load(MultiHeadAttention(heads, d, d_k, d // heads), variables, False)
    _rel(port(_t(q), _t(kv), _t(kv), labels=_t(inputs["labels"]).long()), want, 1e-5)
    # the mask is live: an unmasked call differs
    assert np.abs(port(_t(q), _t(kv), _t(kv)).detach().numpy() - np.asarray(want)).max() > 1e-3


def test_conv_transpose_converts_by_flipping_the_kernel():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, 8, 8, 6)).astype(np.float32)
    mod = fnn.ConvTranspose(5, (4, 4), (2, 2), padding="SAME", use_bias=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(mod.init(jax.random.PRNGKey(0), x)))
    want = _nchw(mod.apply(variables, x))
    tree = {"params": {"dc1": variables["params"]}}
    w = layout2im_state_dict_from_jax(tree)["dc1.weight"]
    assert w.shape == (6, 5, 4, 4)
    xt = _t(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv_transpose2d(xt, w, stride=2, padding=1)
    _rel(got, want, 1e-5)
    unflipped = torch.from_numpy(variables["params"]["kernel"].transpose(2, 3, 0, 1).copy())
    off = torch.nn.functional.conv_transpose2d(xt, unflipped, stride=2, padding=1)
    assert np.abs(off.numpy() - want).max() > 0.1


def test_convlstm_with_pad_steps_matches_jax(inputs):
    rng = np.random.default_rng(16)
    feats = rng.standard_normal((B, O, 4, 4, 6)).astype(np.float32)
    mod = JaxLayoutConvLSTM((5, 3), (3, 3))
    variables = jax.tree_util.tree_map(np.asarray, dict(mod.init(
        jax.random.PRNGKey(0), feats, inputs["valid"])))
    want = fast_jit(mod.apply)(variables, feats, inputs["valid"])
    port = _load(LayoutConvLSTM(6, (5, 3), 3), variables, False)
    got = port(_t(np.moveaxis(feats, -1, 2)), _t(inputs["valid"]))
    _rel(got, _nchw(want), 1e-5)


# ---- networks ----

def _vae_noise(key, shape):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, shape)), np.asarray(jax.random.normal(k2, shape)))


@pytest.fixture(scope="module")
def small_gen(inputs):
    """The JAX convlstm generator at conv_dim 8 and its variables (the
    port's seeded weights, BN statistics moved)."""
    gen = SmallJaxGenerator(num_classes=NC, fusion="convlstm")
    a = inputs
    port = _seeded(pl.Layout2ImGenerator(NC, fusion="convlstm", conv_dim=CD), 0)
    variables = jax_variables(gen, port, a["images"], a["labels"], a["boxes"], a["masks"], a["z"],
                              jax.random.PRNGKey(1))
    return gen, _moved(a["rng"], variables)


def test_crop_encoder_matches_jax(inputs, small_gen):
    _, variables = small_gen
    sub = {k: variables[k]["crop_encoder"] for k in ("params", "batch_stats")}
    mod = jl.CropEncoder(NC, conv_dim=CD)
    crops = np.asarray(jax_crop_boxes(inputs["images"], inputs["boxes"], 32))
    key = jax.random.PRNGKey(3)
    want, new = fast_jit(functools.partial(mod.apply, mutable=["batch_stats"]))(
        sub, crops, inputs["labels"], inputs["valid"], key)
    eps = np.asarray(jax.random.normal(key, (B * O, Z))).reshape(B, O, Z)
    port = _load(pl.CropEncoder(NC, CD), sub, True)
    got = port(_t(_nchw(crops)), _t(inputs["labels"]).long(), _t(inputs["valid"]), _t(eps))
    for g, w, name in zip(got, want, ("z", "mu", "logvar")):
        _abs(g, w, what=name)
    assert _stats_match(port, sub, new) == 10


@pytest.mark.parametrize("fusion", ["convlstm", "transformer_decoder", "transformer",
                                    "transformer_noctx"])
def test_layout_encoder_matches_jax(inputs, small_gen, fusion):
    """Each fusion in training mode (deterministic) and in eval."""
    a = inputs
    cd = 64 if fusion in ("transformer", "transformer_noctx") else CD
    mod = jl.LayoutEncoder(NC, conv_dim=cd, fusion=fusion)
    if fusion == "convlstm":
        _, variables = small_gen
        sub = {k: variables[k]["layout_encoder"] for k in ("params", "batch_stats")}
    else:
        port = _seeded(pl.LayoutEncoder(NC, cd, fusion=fusion), 4)
        sub = _moved(a["rng"], jax_variables(mod, port, a["labels"], a["masks"], a["z"],
                                             a["valid"]))
    apply = jax.jit(functools.partial(mod.apply, mutable=["batch_stats"]),
                    static_argnames=("train",))
    for train in (True, False):
        want, new = apply(sub, a["labels"], a["masks"], a["z"], a["valid"], train=train)
        port = _load(pl.LayoutEncoder(NC, cd, fusion=fusion), sub, train)
        got = port(_t(a["labels"]).long(), _t(a["masks"]), _t(a["z"]), _t(a["valid"]))
        assert got.shape == (B, cd, 8, 8)
        _abs(got, _nchw(want), what=f"train={train}")
    if fusion == "transformer_noctx":
        assert not hasattr(port, "context")


def test_decoder_matches_jax(small_gen):
    _, variables = small_gen
    sub = {k: variables[k]["decoder"] for k in ("params", "batch_stats")}
    h = np.random.default_rng(17).standard_normal((B, 8, 8, CD)).astype(np.float32)
    mod = jl.Decoder(conv_dim=CD)
    for train in (True, False):
        want, new = mod.apply(sub, h, train=train, mutable=["batch_stats"])
        port = _load(pl.Decoder(CD), sub, train)
        _abs(port(_t(_nchw(h))), _nchw(want), what=f"train={train}")
        assert _stats_match(port, sub, new) == 8


def test_generator_forward_and_sample_match_jax(inputs, small_gen):
    """The training forward: every output and the BN statistics it folds
    (crop encoder twice, layout encoder twice, decoder twice, in JAX's
    order); then ``sample`` in eval."""
    gen, variables = small_gen
    a = inputs
    key = jax.random.PRNGKey(5)
    want, new = fast_jit(functools.partial(gen.apply, train=True, mutable=["batch_stats"]))(
        variables, a["images"], a["labels"], a["boxes"], a["masks"], a["z"], key)
    eps_real, eps_rand = (e.reshape(B, O, Z) for e in _vae_noise(key, (B * O, Z)))
    port = _load(pl.Layout2ImGenerator(NC, fusion="convlstm", conv_dim=CD), variables, True)
    got = port(_t(a["images"]).permute(0, 3, 1, 2), _t(a["labels"]).long(), _t(a["boxes"]),
               _t(a["masks"]), _t(a["z"]), _t(eps_real), _t(eps_rand))
    assert set(got) == set(want)
    for k, v in want.items():
        _abs(got[k], _nchw(v) if np.ndim(v) >= 4 else v, what=k)
    assert _stats_match(port, variables, new, tol=1e-4) > 30
    want_s = fast_jit(functools.partial(gen.apply, method=jl.Layout2ImGenerator.sample))(
        variables, a["labels"], a["boxes"], a["masks"], a["z"])
    port.eval()
    got_s = port.sample(_t(a["labels"]).long(), _t(a["boxes"]), _t(a["masks"]), _t(a["z"]))
    assert got_s.shape == (B, 3, 64, 64)
    _abs(got_s, _nchw(want_s), what="sample")
