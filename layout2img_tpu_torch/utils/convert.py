"""Weights for the port's generator, discriminator and perceptual loss.

``generator_state_dict_from_jax`` and ``discriminator_state_dict_from_jax``
turn the JAX package's variable trees (``params``, ``batch_stats``,
``spectral``; numpy arrays) into the reference-format state dicts the port's
modules are named after. They are this package's own copy of
``layout2img_tpu/utils/torch_export.py``'s generator and discriminator
exporters (every LostGAN preset and D):

- Linear kernel (in, out) -> weight (out, in); conv (kh, kw, in, out) -> (out, in, kh, kw)
- spectral norm: ``weight_orig``, ``weight_u`` and ``weight_v = normalize(W^T u)``
- BN stats -> ``running_mean``/``running_var`` and ``num_batches_tracked = 0``
- alpha (n,) -> (1, n, 1); attention ``geo_proj`` Dense(64 -> h) -> h x ``WGs.{i}``
- GCN ``gc{1,2}_w`` (in, out) and ``_b`` -> ``context.gc{1,2}.weight`` / ``.bias`` as they are
- SN embedding table (num, dim) -> ``weight_orig`` as it is

``vgg19_state_dict_from_jax`` is the inverse of the JAX package's
``losses/perceptual.py::load_torch_vgg19_features``: flax ``conv{i}`` params
-> torchvision ``features.{j}`` names.

``inception_state_dict_from_jax`` and ``lpips_state_dict_from_jax`` are the
inverses of the JAX package's ``eval/inception.py::load_torch_inception_v3``
and ``eval/lpips.py::load_torch_lpips``: the eval nets' flax variables ->
torchvision-named state dicts of ``eval.inception.InceptionV3`` and
``eval.lpips.LPIPS``.

``bgfg_generator_state_dict_from_jax`` is ``export_bgfg_generator``'s copy for
the Ours-ED generator: both streams as 64px feature-only generators under
``background_g.``/``foreground_g.``, the ``combination`` block (its convs
plain, and ``conv1``/``conv2`` repeated as ``model.2``/``model.5``) and the
RGB head. ``layout2im_state_dict_from_jax`` maps the layout2im family's
variables (the generator or either discriminator; JAX has no reference
export for them) onto the port's names, which follow the JAX module names:
kernels and tables as above, a flax ``ConvTranspose`` kernel (kh, kw, in,
out) flipped in both spatial axes into ``ConvTranspose2d``'s (in, out, kh,
kw), LayerNorm and BN ``scale`` -> ``weight``, BN statistics ->
``running_mean``/``running_var``, the decoder's learned ``query`` as it is.

``init_generator``, ``init_discriminator``, ``init_bgfg_generator``,
``init_layout2im_generator``, ``init_layout2im_discriminators`` and
``init_vgg`` give seeded random weights where no JAX checkpoint is at hand
(the GPU machine has no JAX).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.eval.lpips import ALEX_CONV_INDEX
from layout2img_tpu_torch.losses.perceptual import VGG19_CFG, VGG19Features
from layout2img_tpu_torch.models.discriminators import LayoutDiscriminator, make_discriminator
from layout2img_tpu_torch.models.generators import BgFgGenerator, LostGANGenerator, make_generator
from layout2img_tpu_torch.models.layout2im import (ConditionalBatchNorm, Layout2ImGenerator,
                                                   Layout2ImImageDiscriminator,
                                                   Layout2ImObjectDiscriminator, MaskedBatchNorm,
                                                   TransformerDecoder)
from layout2img_tpu_torch.nn.attention import MultiHeadAttention
from layout2img_tpu_torch.nn.gcn import GraphConvolution
from layout2img_tpu_torch.nn.norms import SyncBatchNorm
from layout2img_tpu_torch.nn.spectral import SNConv, SNDense, _SNWeight


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def _l2n(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), eps)


class _Converter:
    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.spectral = variables.get("spectral", {})
        self.out: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def emit(self, name: str, arr) -> None:
        self.out[name] = _np(arr)

    def _sn(self, name: str, w: np.ndarray, path) -> None:
        u = _np(self._get(self.spectral, path)["u"]).astype(np.float32)
        self.emit(f"{name}.weight_orig", w)
        self.emit(f"{name}.weight_u", u)
        self.emit(f"{name}.weight_v", _l2n(w.reshape(w.shape[0], -1).astype(np.float32).T @ u))

    def _weight(self, name: str, path, w: np.ndarray, sn: bool) -> None:
        if sn:
            self._sn(name, w, path)
        else:
            self.emit(f"{name}.weight", w)
        node = self._get(self.params, path)
        if "bias" in node:
            self.emit(f"{name}.bias", node["bias"])

    def linear(self, name: str, path, sn: bool) -> None:
        self._weight(name, path, _np(self._get(self.params, path)["kernel"]).T, sn)

    def conv(self, name: str, path, sn: bool) -> None:
        w = _np(self._get(self.params, path)["kernel"]).transpose(3, 2, 0, 1)
        self._weight(name, path, w, sn)

    def embed_sn(self, name: str, path) -> None:
        self._sn(name, _np(self._get(self.params, path)["embedding"]), path)

    def bn(self, name: str, path) -> None:
        try:
            node = self._get(self.params, path)
        except KeyError:  # affine=False BN (the ISLA norms)
            node = {}
        if "scale" in node:
            self.emit(f"{name}.weight", node["scale"])
            self.emit(f"{name}.bias", node["bias"])
        stats = self._get(self.stats, path)
        self.emit(f"{name}.running_mean", stats["mean"])
        self.emit(f"{name}.running_var", stats["var"])
        self.emit(f"{name}.num_batches_tracked", np.asarray(0, np.int64))


def generator_state_dict_from_jax(variables: dict, res_start: int = 1) -> dict[str, torch.Tensor]:
    """JAX ``LostGANGenerator`` variables (every preset) -> the port's state
    dict, in ``export_lostgan_generator``'s key order. ``res_start`` is the
    reference's first block number: 1, or 2 for the 64px generator
    (``res2..res5``), as the exporter takes it.

    An attention context without its geometry term (the nogeo presets) has
    no ``geo_proj`` in JAX, but the reference's module and its ``.pth``
    files carry ``context.WGs.*``, unused; they are written as zeros."""
    e = _Converter(variables)
    p = e.params
    e.emit("label_embedding.weight", p["label_embedding"]["embedding"])

    c = p.get("context", {})
    if "q_proj" in c:  # box attention
        for i, name in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
            e.linear(f"context.linears.{i}", ("context", name), sn=False)
        geo = c.get("geo_proj", {"kernel": np.zeros((64, 1), np.float32),
                                 "bias": np.zeros((1,), np.float32)})
        gk, gb = _np(geo["kernel"]), _np(geo["bias"])  # (64, h), (h,)
        for h in range(gk.shape[1]):
            e.emit(f"context.WGs.{h}.weight", gk[:, h][None, :])
            e.emit(f"context.WGs.{h}.bias", gb[h:h + 1])
        for mine, name in (("ln0", "layer_norm0"), ("ln1", "layer_norm")):
            e.emit(f"context.{name}.weight", c[mine]["scale"])
            e.emit(f"context.{name}.bias", c[mine]["bias"])
    elif "gc1_w" in c:  # GCN
        for gc in ("gc1", "gc2"):
            e.emit(f"context.{gc}.weight", c[f"{gc}_w"])
            e.emit(f"context.{gc}.bias", c[f"{gc}_b"])

    e.linear("fc", ("fc",), sn=True)

    blocks = sorted((k for k in p if k.startswith("res")), key=lambda s: int(s[3:]))
    for i, blk in enumerate(blocks):
        tb = f"res{res_start + i}"
        for sub in ("conv1", "conv2", "c_sc"):
            if sub in p[blk]:
                e.conv(f"{tb}.{sub}", (blk, sub), sn=True)
        for nrm in ("b1", "b2"):
            e.linear(f"{tb}.{nrm}.weight_proj", (blk, nrm, "weight_proj"), sn=True)
            e.linear(f"{tb}.{nrm}.bias_proj", (blk, nrm, "bias_proj"), sn=True)
            e.bn(f"{tb}.{nrm}.batch_norm2d", (blk, nrm, "bn"))
        if "mask_conv1" in p[blk]:  # plain conv stage-mask head
            e.conv(f"{tb}.conv_mask.0", (blk, "mask_conv1"), sn=False)
            e.bn(f"{tb}.conv_mask.1", (blk, "mask_bn"))
            e.conv(f"{tb}.conv_mask.3", (blk, "mask_conv2"), sn=False)
        elif "psp" in p[blk]:  # PSP stage-mask head
            s = 0
            while f"stage{s}_conv" in p[blk]["psp"]:
                e.conv(f"{tb}.conv_mask.0.stages.{s}.1", (blk, "psp", f"stage{s}_conv"), sn=False)
                e.bn(f"{tb}.conv_mask.0.stages.{s}.2", (blk, "psp", f"stage{s}_bn"))
                s += 1
            e.conv(f"{tb}.conv_mask.0.bottleneck.0", (blk, "psp", "bottleneck_conv"), sn=False)
            e.bn(f"{tb}.conv_mask.0.bottleneck.1", (blk, "psp", "bottleneck_bn"))
            e.conv(f"{tb}.conv_mask.1", (blk, "conv_mask"), sn=False)

    i = 1
    while f"alpha{i}" in p:
        e.emit(f"alpha{i}", _np(p[f"alpha{i}"]).reshape(1, -1, 1))
        i += 1

    if "final_conv" in p:  # the feature-only generators have no RGB head
        e.bn("final.0", ("final_bn",))
        e.conv("final.2", ("final_conv",), sn=True)

    e.linear("mask_regress.fc", ("mask_regress", "fc"), sn=True)
    for mine, name in (("conv1", "conv1.0"), ("conv2", "conv2.0"),
                       ("conv3a", "conv3.0"), ("conv3b", "conv3.3")):
        e.conv(f"mask_regress.{name}", ("mask_regress", mine), sn=True)
    for mine, name in (("bn1", "conv1.1"), ("bn2", "conv2.1"), ("bn3", "conv3.1")):
        if mine in e.stats.get("mask_regress", {}):  # the v1 trunk
            e.bn(f"mask_regress.{name}", ("mask_regress", mine))
    return {k: torch.from_numpy(np.array(v)) for k, v in e.out.items()}


def bgfg_generator_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``BgFgGenerator`` variables -> the port's (and the reference's)
    state dict, key for key ``export_bgfg_generator``'s."""
    out: dict[str, torch.Tensor] = {}
    for stream in ("background_g", "foreground_g"):
        sub = {kind: variables.get(kind, {}).get(stream, {})
               for kind in ("params", "batch_stats", "spectral")}
        out.update({f"{stream}.{k}": v
                    for k, v in generator_state_dict_from_jax(sub, res_start=2).items()})
    e = _Converter(variables)
    for name, mine in (("model.0", "bn1"), ("model.3", "bn2"), ("bn", "bn_sc")):
        e.bn(f"combination.{name}", ("combination", mine))
    for conv in ("conv1", "conv2", "conv3"):
        e.conv(f"combination.{conv}", ("combination", conv), sn=False)
    for alias, real in (("model.2", "conv1"), ("model.5", "conv2")):
        for kind in ("weight", "bias"):
            e.out[f"combination.{alias}.{kind}"] = e.out[f"combination.{real}.{kind}"]
    e.bn("final.0", ("final_bn",))
    e.conv("final.2", ("final_conv",), sn=True)
    out.update({k: torch.from_numpy(np.array(v)) for k, v in e.out.items()})
    return out


def layout2im_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``Layout2ImGenerator``, ``Layout2ImImageDiscriminator`` or
    ``Layout2ImObjectDiscriminator`` variables -> the port module's state
    dict. A layer with an entry in ``spectral`` is spectrally normalized."""
    e = _Converter({"params": {}, **variables})

    def is_sn(path) -> bool:
        try:
            e._get(e.spectral, path)
            return True
        except KeyError:
            return False

    def walk(node: dict, path: tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            name = ".".join(path)

            def key(leaf: str) -> str:
                return f"{name}.{leaf}" if name else leaf

            arr = _np(v)
            if k in ("kernel", "embedding"):
                if k == "kernel" and arr.ndim == 4:
                    arr = (np.flip(arr, (0, 1)).transpose(2, 3, 0, 1) if path[-1].startswith("dc")
                           else arr.transpose(3, 2, 0, 1))
                elif k == "kernel":
                    arr = arr.T
                if is_sn(path):
                    e._sn(name, arr, path)
                else:
                    e.emit(key("weight"), arr)
            elif k in ("bias", "query"):
                e.emit(key(k), arr)
            elif k == "scale":
                e.emit(key("weight"), arr)
            else:
                raise ValueError(f"unknown layout2im parameter {path + (k,)}")

    walk(e.params, ())
    stats = {}

    def walk_stats(node: dict, path: tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk_stats(v, path + (k,))
            else:
                leaf = {"mean": "running_mean", "var": "running_var"}[k]
                stats[".".join(path + (leaf,))] = _np(v)

    walk_stats(e.stats, ())
    return {k: torch.from_numpy(np.array(v)) for k, v in {**e.out, **stats}.items()}


def discriminator_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``LayoutDiscriminator`` variables (every preset) -> the port's
    state dict, in ``export_lostgan_discriminator``'s key order."""
    e = _Converter(variables)
    for key in sorted(e.params):
        if key.startswith("block") or key == "app_conv":
            for sub in ("conv1", "conv2", "c_sc"):
                if sub in e.params[key]:
                    e.conv(f"{key}.{sub}", (key, sub), sn=True)
        elif key in ("l7", "l8", "l_im", "l_obj", "app"):
            e.linear(key, (key,), sn=True)
        elif key in ("l_y", "l_y_app"):
            e.embed_sn(key, (key,))
        else:
            raise ValueError(f"unknown discriminator component {key!r}")
    return {k: torch.from_numpy(np.array(v)) for k, v in e.out.items()}


def vgg19_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``VGG19Features`` params (``conv{i}``: kernel (3, 3, in, out),
    bias) -> ``VGG19Features`` state dict (``features.{j}.weight`` (out, in,
    3, 3), ``.bias``)."""
    out: dict[str, torch.Tensor] = {}
    conv, j = 0, 0  # conv ordinal, index in ``features`` (a conv and its ReLU, or a pool)
    for item in VGG19_CFG:
        if item == "M":
            j += 1
            continue
        node = params[f"conv{conv}"]
        out[f"features.{j}.weight"] = torch.from_numpy(_np(node["kernel"]).transpose(3, 2, 0, 1).copy())
        out[f"features.{j}.bias"] = torch.from_numpy(_np(node["bias"]).copy())
        conv, j = conv + 1, j + 2
    return out


def inception_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``InceptionV3`` variables (``params``, ``batch_stats``) ->
    ``InceptionV3`` state dict: conv ``kernel`` (h, w, in, out) ->
    ``conv.weight`` (out, in, h, w); BN ``scale``/``bias``/``mean``/``var`` ->
    ``bn.weight``/``bias``/``running_mean``/``running_var`` (and
    ``num_batches_tracked`` 0); ``fc.kernel`` (in, out) -> ``fc.weight`` (out, in)."""
    out: dict[str, np.ndarray] = {}
    leaf = {("conv", "kernel"): "conv.weight", ("bn", "scale"): "bn.weight",
            ("bn", "bias"): "bn.bias", ("bn", "mean"): "bn.running_mean",
            ("bn", "var"): "bn.running_var", ("fc", "kernel"): "fc.weight",
            ("fc", "bias"): "fc.bias"}

    def walk(tree: dict, path: tuple[str, ...]) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            name = ".".join(path[:-1] + (leaf[path[-1:] + (k,)],))
            arr = _np(v)
            if k == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[name] = arr
            if name.endswith("bn.running_mean"):
                out[name.removesuffix("running_mean") + "num_batches_tracked"] = np.int64(0)

    walk(variables["params"], ())
    walk(variables["batch_stats"], ())
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def lpips_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``LPIPS`` variables (``params`` ``conv0..conv4``, ``lins``) ->
    ``LPIPS`` state dict (``net.features.{0,3,6,8,10}.weight``/``bias``,
    ``lin0..lin4``)."""
    out: dict[str, torch.Tensor] = {}
    for n, idx in enumerate(ALEX_CONV_INDEX):
        node = variables["params"][f"conv{n}"]
        out[f"net.features.{idx}.weight"] = torch.from_numpy(
            _np(node["kernel"]).transpose(3, 2, 0, 1).copy())
        out[f"net.features.{idx}.bias"] = torch.from_numpy(_np(node["bias"]).copy())
    for i, lin in enumerate(variables["lins"]):
        out[f"lin{i}"] = torch.from_numpy(_np(lin).astype(np.float32))
    return out


# the std of a standard normal truncated to [-2, 2]
_TRUNCATED_STD = .87962566103423978


def _truncated_(w: torch.Tensor, variance: float, g: torch.Generator) -> None:
    """flax's ``variance_scaling(..., "truncated_normal")`` draw: a standard
    normal truncated to [-2, 2], scaled to ``variance``."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    w.mul_(variance ** 0.5 / _TRUNCATED_STD)


@torch.no_grad()
def _init_(gen: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter and buffer of a CPU module from ``g``:
    orthogonal weights as the JAX package initializes them, zero biases,
    identity BN statistics, zero alphas, Gaussian SN vectors, lecun-normal
    plain convs (flax's: a normal truncated at two of its standard
    deviations, with variance 1 / fan_in), and the GCN's weights and biases
    uniform in ±1/sqrt(out) (the reference's ``GraphConvolution``)."""

    def ortho(w: torch.Tensor) -> None:
        mat = torch.empty(w.shape[0], w[0].numel())
        nn.init.orthogonal_(mat, generator=g)
        w.copy_(mat.reshape(w.shape))

    for mod in gen.modules():
        if isinstance(mod, _SNWeight):
            ortho(mod.weight_orig)
            mod.weight_u.normal_(generator=g)
            w_mat = mod.weight_orig.reshape(mod.weight_orig.shape[0], -1)
            mod.weight_v.copy_(nn.functional.normalize(w_mat.T @ mod.weight_u, dim=0, eps=1e-12))
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            ortho(mod.weight)
        elif isinstance(mod, nn.Conv2d):
            _truncated_(mod.weight, 1.0 / mod.weight[0].numel(), g)  # lecun normal
        elif isinstance(mod, GraphConvolution):
            bound = mod.weight.shape[1] ** -0.5
            for t in (mod.weight, mod.bias):
                t.uniform_(-bound, bound, generator=g)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, SyncBatchNorm):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
            if mod.weight is not None:
                mod.weight.fill_(1.0)
        bias = getattr(mod, "bias", None)
        if isinstance(mod, (SNDense, SNConv, nn.Linear, nn.Conv2d, nn.LayerNorm, SyncBatchNorm)) \
                and bias is not None:
            bias.zero_()
    for name, param in gen.named_parameters(recurse=False):
        if name.startswith("alpha"):
            param.zero_()


def init_generator(seed: int, num_classes: int, preset: str = "ours_d_context128",
                   device: str | torch.device | None = None, **overrides) -> LostGANGenerator:
    """A generator with seeded random weights, on ``device`` (default cuda).

    The weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
    so one seed gives the same weights on every device."""
    dev = resolve_device(device)
    gen = make_generator(preset, num_classes, device="cpu", **overrides)
    _init_(gen, torch.Generator().manual_seed(seed))
    return gen.to(dev)


def init_discriminator(seed: int, num_classes: int, preset: str = "d128_app",
                       device: str | torch.device | None = None, **overrides) -> LayoutDiscriminator:
    """A discriminator with seeded random weights, on ``device`` (default
    cuda), drawn on the CPU as ``init_generator`` draws them."""
    dev = resolve_device(device)
    disc = make_discriminator(preset, num_classes, device="cpu", **overrides)
    _init_(disc, torch.Generator().manual_seed(seed))
    return disc.to(dev)


def _empty(cls, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` on the CPU in eval mode, its tensors
    allocated but not filled (built on the meta device: no default init
    draws from torch's global generator)."""
    with torch.device("meta"):
        net = cls(*args, **kwargs)
    return net.to_empty(device="cpu").eval()


def init_bgfg_generator(seed: int, num_fg_classes: int = 91, num_bg_classes: int = 93,
                        device: str | torch.device | None = None, **overrides) -> BgFgGenerator:
    """The Ours-ED generator with seeded random weights, on ``device``
    (default cuda), drawn on the CPU as ``init_generator`` draws them; the
    combination block's plain convs xavier-uniform, as the JAX package's."""
    dev = resolve_device(device)
    gen = _empty(BgFgGenerator, num_fg_classes, num_bg_classes, **overrides)
    g = torch.Generator().manual_seed(seed)
    _init_(gen, g)
    with torch.no_grad():
        for conv in (gen.combination.conv1, gen.combination.conv2, gen.combination.conv3):
            nn.init.xavier_uniform_(conv.weight, generator=g)
    return gen.to(dev)


@torch.no_grad()
def _init_layout2im_(net: nn.Module, g: torch.Generator) -> None:
    """``_init_`` with the layout2im family's initializers on top, as the
    JAX modules draw them: lecun-normal convs, transposed convs and linears
    (the attention's projections normal with std sqrt(2 / (d_model + d_k)),
    its ``fc`` xavier-normal; lecun and xavier normals truncated as flax's),
    the label embedding normal with std
    dim^-1/2, the conditional BN's gamma N(0, 0.02) and beta 0, the
    decoder's query uniform in [0, 1)."""
    _init_(net, g)

    def lecun(w: torch.Tensor, fan_in: int) -> None:
        _truncated_(w, 1.0 / fan_in, g)

    for mod in net.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            lecun(mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel())
        elif isinstance(mod, nn.Linear):
            lecun(mod.weight, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, MaskedBatchNorm):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            if mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        elif isinstance(mod, TransformerDecoder):
            mod.query.uniform_(0.0, 1.0, generator=g)
    for mod in net.modules():  # after the generic linears above
        if isinstance(mod, MultiHeadAttention):
            d_model = mod.ln0.normalized_shape[0]
            for lin, d in ((mod.w_qs, mod.d_k), (mod.w_ks, mod.d_k), (mod.w_vs, mod.d_v)):
                lin.weight.normal_(std=(2.0 / (d_model + d)) ** 0.5, generator=g)
            _truncated_(mod.fc.weight, 2.0 / sum(mod.fc.weight.shape), g)  # xavier normal
        elif isinstance(mod, ConditionalBatchNorm):
            mod.gamma.weight.normal_(std=0.02, generator=g)
            mod.beta.weight.zero_()
    if isinstance(net, Layout2ImGenerator):
        emb = net.layout_encoder.embedding.weight
        emb.normal_(std=emb.shape[1] ** -0.5, generator=g)


def init_layout2im_generator(seed: int, num_classes: int, fusion: str = "transformer",
                             device: str | torch.device | None = None,
                             **overrides) -> Layout2ImGenerator:
    """The layout2im generator with seeded random weights, on ``device``
    (default cuda), drawn on the CPU."""
    dev = resolve_device(device)
    gen = _empty(Layout2ImGenerator, num_classes, fusion=fusion, **overrides)
    _init_layout2im_(gen, torch.Generator().manual_seed(seed))
    return gen.to(dev)


def init_layout2im_discriminators(seed: int, num_classes: int, conv_dim: int = 64,
                                  device: str | torch.device | None = None
                                  ) -> tuple[Layout2ImImageDiscriminator,
                                             Layout2ImObjectDiscriminator]:
    """The layout2im image and object discriminators (spectrally normalized,
    as the trainers build them) with seeded random weights (the object D's
    from ``seed + 1``), on ``device`` (default cuda), in eval mode."""
    dev = resolve_device(device)
    d_img = _empty(Layout2ImImageDiscriminator, conv_dim)
    d_obj = _empty(Layout2ImObjectDiscriminator, num_classes, conv_dim)
    _init_layout2im_(d_img, torch.Generator().manual_seed(seed))
    _init_layout2im_(d_obj, torch.Generator().manual_seed(seed + 1))
    return d_img.to(dev), d_obj.to(dev)


def init_vgg(seed: int, device: str | torch.device | None = None) -> VGG19Features:
    """VGG19 features to relu5_1 with seeded random filters (lecun normal,
    truncated as flax's; zero biases), on ``device`` (default cuda)."""
    dev = resolve_device(device)
    vgg = VGG19Features()
    _init_(vgg, torch.Generator().manual_seed(seed))
    return vgg.to(dev)
