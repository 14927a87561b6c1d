"""The layout2im CVAE-GAN family with the paper's context and appearance
modules (counterpart of ``layout2img_tpu/models/layout2im.py``), NCHW.

- ``CropEncoder``: object crops -> a VAE posterior over z, with per-class
  conditional BN (reference ``generator_app.py:719-774``).
- ``LayoutEncoder``: object embedding || z, a context attention over the
  objects, the vectors broadcast into the box masks, down-convs to 8x8, then
  the fusion over objects (``generator_app.py:777-861``): ``transformer``
  (the masked per-image sum refined by 3 self-attention layers over the 64
  spatial tokens), ``convlstm`` (the upstream layout2im baseline; no c5/bn5),
  ``transformer_decoder`` (64 learned queries cross-attend into the summed
  tokens, ``generator1.py``) or ``transformer_noctx`` (``transformer``
  without the object context attention, ``generator2.py``); then 6 residual
  blocks.
- ``Decoder``: 8x8 -> 64x64 image (``generator_app.py:864-899``), its
  upsampling convs ``ConvTranspose2d(k=4, s=2, p=1)`` (a flax
  ``ConvTranspose(padding="SAME")`` with its kernel flipped in both spatial
  axes: ``utils/convert.py`` does that).
- ``Layout2ImGenerator``: the training forward (``generator_app.py:902-962``)
  and ``sample``, layout-to-image from random z.
- ``Layout2ImImageDiscriminator`` and ``Layout2ImObjectDiscriminator`` (with
  the AC-GAN classifier and the Gram appearance head), optionally without
  spectral norm (``discriminator_app.py:29-187``).

As in the JAX package, objects are a padded (b, o) axis with a validity
mask; ``MaskedBatchNorm`` takes its statistics over the valid object slots
only. The JAX call's ``train`` flag is the module's mode: ``.train()`` uses
and folds batch statistics (and runs the discriminators' SN power
iterations), ``.eval()`` uses the running statistics. The VAE noise that the
JAX ``CropEncoder`` draws inside is an input here (``eps``). Parameter names
follow the JAX module names; ``utils/convert.py`` maps JAX variables onto
them (JAX has no reference-format export for this family, so these names
are the format of its ``.pth`` files).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from layout2img_tpu_torch.models.convlstm import LayoutConvLSTM
from layout2img_tpu_torch.nn.attention import MultiHeadAttention
from layout2img_tpu_torch.nn.spectral import SNConv, SNDense, SNEmbed
from layout2img_tpu_torch.ops.interp import crop_boxes
from layout2img_tpu_torch.parallel import mesh as data_mesh

MOMENTUM = 0.1
FUSIONS = ("transformer", "convlstm", "transformer_decoder", "transformer_noctx")


def _global_moments(mesh, xf: torch.Tensor, mask: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2], n) per channel over every rank's (masked) entries:
    the sums over the ranks of x and x^2 (differentiable) and of the count."""
    hw = xf.shape[2] * xf.shape[3]
    if mask is None:
        m, count = xf, torch.tensor(float(xf.shape[0] * hw), device=xf.device)
    else:
        w = mask.to(torch.float32)[:, None, None, None]
        m, count = xf * w, w.sum() * hw
    sums = mesh.sum(torch.stack([m.sum(dim=(0, 2, 3)), (m * xf).sum(dim=(0, 2, 3))]))
    n = mesh.sum_detached(count, "bn_sum").clamp_min(1.0)
    return sums[0] / n, sums[1] / n, n


class MaskedBatchNorm(nn.Module):
    """BN over (entries, h, w) of (n, c, h, w), where only the entries with
    ``mask`` (n,) > 0 count. Batch statistics in f32, the variance one-pass
    (``max(E[x^2] - E[x]^2, 0)``); the running variance is unbiased by the
    masked count n = sum(mask) * h * w; momentum 0.1. Under a data-parallel
    mesh the sums and the count are every rank's (``parallel/mesh.py``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.to(torch.float32)
            mesh = data_mesh.current()
            if mesh.world > 1:
                mean, mean_sq, n = _global_moments(mesh, xf, mask)
            elif mask is None:
                mean = xf.mean(dim=(0, 2, 3))
                mean_sq = xf.square().mean(dim=(0, 2, 3))
                n = torch.tensor(float(x.numel() // x.shape[1]), device=x.device)
            else:
                m = mask.to(torch.float32)[:, None, None, None]
                n = (m.sum() * x.shape[2] * x.shape[3]).clamp_min(1.0)
                mean = (xf * m).sum(dim=(0, 2, 3)) / n
                mean_sq = (xf.square() * m).sum(dim=(0, 2, 3)) / n
            var = (mean_sq - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * (n / (n - 1).clamp_min(1.0))
                self.running_mean.copy_((1 - MOMENTUM) * self.running_mean + MOMENTUM * mean)
                self.running_var.copy_((1 - MOMENTUM) * self.running_var + MOMENTUM * unbiased)
        y = (x.to(torch.float32) - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ConditionalBatchNorm(nn.Module):
    """``MaskedBatchNorm`` without affine, then a per-class (gamma, beta):
    gamma = 1 + an embedding initialized N(0, 0.02), beta an embedding
    initialized 0 (reference ``generator_app.py:382-395``)."""

    def __init__(self, num_classes: int, num_features: int):
        super().__init__()
        self.bn = MaskedBatchNorm(num_features, affine=False)
        self.gamma = nn.Embedding(num_classes, num_features)
        self.beta = nn.Embedding(num_classes, num_features)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        y = self.bn(x, mask)
        gamma = self.gamma(labels) + 1.0
        return y * gamma[:, :, None, None] + self.beta(labels)[:, :, None, None]


class TransformerEncoder(nn.Module):
    """N self-attention layers, 4 heads, d_model 512, d_k = d_v = 128
    (``transformer.py:144-153``)."""

    def __init__(self, num_layers: int = 3, d_model: int = 512, heads: int = 4, d_k: int = 128):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", MultiHeadAttention(heads, d_model, d_k, d_k))

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, x, x, deterministic=deterministic)
        return x


class TransformerDecoder(nn.Module):
    """The learned-query set decoder (``transformer.py:156-177``): the queries
    attend to themselves, then into x, then N - 1 self-attention layers. The
    query is a parameter (the reference's ``.cuda()`` detaches it)."""

    def __init__(self, num_layers: int = 2, num_queries: int = 64, d_model: int = 192,
                 d_k: int = 64):
        super().__init__()
        self.num_layers = num_layers
        self.query = nn.Parameter(torch.rand(1, num_queries, d_model))
        for i in range(num_layers + 1):
            self.add_module(f"layer{i}", MultiHeadAttention(1, d_model, d_k, d_model))

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                deterministic: bool = True) -> torch.Tensor:
        q = self.layer0(self.query, self.query, self.query, deterministic=deterministic)
        q = q.expand(x.shape[0], -1, -1)
        x = self.layer1(q, x, x, labels=labels, deterministic=deterministic)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"layer{i + 2}")(x, x, x, deterministic=deterministic)
        return x


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class CropEncoder(nn.Module):
    """Object crop -> VAE posterior (``generator_app.py:719-774``)."""

    def __init__(self, num_classes: int, conv_dim: int = 64, z_dim: int = 8):
        super().__init__()
        cd = conv_dim
        specs = [(3, cd, 7, 1, 3), (cd, 2 * cd, 4, 2, 1), (2 * cd, 4 * cd, 4, 2, 1),
                 (4 * cd, 8 * cd, 4, 2, 1), (8 * cd, 16 * cd, 4, 2, 1)]
        for i, (cin, cout, k, s, p) in enumerate(specs):
            self.add_module(f"c{i + 1}", _conv(cin, cout, k, s, p))
            self.add_module(f"bn{i + 1}", ConditionalBatchNorm(num_classes, cout))
        self.fc_mu = nn.Linear(16 * cd, z_dim)
        self.fc_logvar = nn.Linear(16 * cd, z_dim)

    def forward(self, crops: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """crops (b, o, 3, s, s); labels, valid (b, o); eps (b, o, z_dim)
        standard normal -> (z, mu, logvar), each (b, o, z_dim)."""
        b, o = labels.shape
        x = crops.reshape(b * o, *crops.shape[2:])
        lab, msk = labels.reshape(-1), valid.reshape(-1)
        for i in range(1, 6):
            x = getattr(self, f"bn{i}")(getattr(self, f"c{i}")(x), lab, msk).relu()
        x = x.mean(dim=(2, 3))
        mu, logvar = self.fc_mu(x), self.fc_logvar(x)
        z = eps.reshape(mu.shape).to(mu.dtype) * torch.exp(0.5 * logvar) + mu
        return tuple(t.reshape(b, o, -1) for t in (z, mu, logvar))


class LayoutEncoder(nn.Module):
    """(labels, masks, z) -> the fused 8x8 feature map (``generator_app.py:777-861``)."""

    def __init__(self, num_classes: int, conv_dim: int = 64, z_dim: int = 8,
                 embedding_dim: int = 64, resi_num: int = 6, fusion: str = "transformer"):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
        cd, d = conv_dim, embedding_dim + z_dim
        self.fusion, self.resi_num = fusion, resi_num
        self.embedding = nn.Embedding(num_classes, embedding_dim)
        if fusion != "transformer_noctx":
            self.context = MultiHeadAttention(1, d, d, d, dropout_rate=0.0)
        # c1 is k1 with padding 1 (64 -> 66, a reference quirk), then 66 -> 33 -> 16 -> 8
        specs = [(d, cd, 1, 1, 1), (cd, 2 * cd, 4, 2, 1), (2 * cd, 4 * cd, 4, 2, 1),
                 (4 * cd, 8 * cd, 4, 2, 1)]
        for i, (cin, cout, k, s, p) in enumerate(specs):
            self.add_module(f"c{i + 1}", _conv(cin, cout, k, s, p))
            self.add_module(f"bn{i + 1}", ConditionalBatchNorm(num_classes, cout))
        if fusion == "convlstm":
            self.clstm = LayoutConvLSTM(8 * cd, (2 * cd, cd, cd))
        else:
            if fusion == "transformer_decoder":
                self.transformer_decoder = TransformerDecoder(3, 64, 8 * cd)
            else:
                self.transformer_encoder = TransformerEncoder(3)
            self.c5 = _conv(8 * cd, cd, 3, padding=1)
            self.bn5 = MaskedBatchNorm(cd)
        for i in range(resi_num):
            for j in (1, 2):
                self.add_module(f"res{i}_conv{j}", _conv(cd, cd, 3, padding=1))
                self.add_module(f"res{i}_bn{j}", MaskedBatchNorm(cd))

    def forward(self, labels: torch.Tensor, masks: torch.Tensor, z: torch.Tensor,
                valid: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """labels, valid (b, o); masks (b, o, 64, 64); z (b, o, z_dim) -> (b, cd, 8, 8)."""
        b, o = labels.shape
        vec = torch.cat([self.embedding(labels).to(z.dtype), z], dim=-1)  # (b, o, d)
        if self.fusion != "transformer_noctx":
            vec = self.context(vec, vec, vec, labels=labels, deterministic=deterministic)
        # each object's vector broadcast into its mask footprint
        h = (vec[:, :, :, None, None] * masks[:, :, None]).reshape(b * o, vec.shape[-1],
                                                                   *masks.shape[-2:])
        lab, msk = labels.reshape(-1), valid.reshape(-1)
        for i in range(1, 5):
            h = getattr(self, f"bn{i}")(getattr(self, f"c{i}")(h), lab, msk)
            if i < 4:
                h = h.relu()
        h = h.reshape(b, o, *h.shape[1:])
        if self.fusion == "convlstm":
            h = self.clstm(h, valid)
        else:
            # the masked per-image sum over objects, then 64 spatial tokens
            h = torch.einsum("bochw,bo->bchw", h, valid.to(h.dtype))
            c = h.shape[1]
            tokens = h.flatten(2).transpose(1, 2)  # (b, 64, c), row-major (y, x)
            if self.fusion == "transformer_decoder":
                tokens = self.transformer_decoder(tokens, deterministic=deterministic)
            else:
                tokens = self.transformer_encoder(tokens, deterministic=deterministic)
            h = tokens.transpose(1, 2).reshape(b, c, 8, 8)
            h = self.bn5(self.c5(h)).relu()
        for i in range(self.resi_num):
            r = getattr(self, f"res{i}_bn1")(getattr(self, f"res{i}_conv1")(h)).relu()
            h = h + getattr(self, f"res{i}_bn2")(getattr(self, f"res{i}_conv2")(r))
        return h


class Decoder(nn.Module):
    """(b, cd, 8, 8) -> (b, 3, 64, 64) (``generator_app.py:864-899``); no tanh."""

    def __init__(self, conv_dim: int = 64):
        super().__init__()
        cd = conv_dim
        self.c0 = _conv(cd, 4 * cd, 3, padding=1)
        self.bn0 = MaskedBatchNorm(4 * cd)
        for i, (cin, cout) in enumerate(((4 * cd, 4 * cd), (4 * cd, 2 * cd), (2 * cd, cd))):
            self.add_module(f"dc{i + 1}", nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1,
                                                             bias=False))
            self.add_module(f"bn{i + 1}", MaskedBatchNorm(cout))
        self.c4 = nn.Conv2d(cd, 3, 7, padding=3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.bn0(self.c0(h)).relu()
        for i in range(1, 4):
            h = getattr(self, f"bn{i}")(getattr(self, f"dc{i}")(h)).relu()
        return self.c4(h)


class Layout2ImGenerator(nn.Module):
    """The CVAE-GAN generator (``generator_app.py:902-962``, the
    ``Generator_context`` variant)."""

    def __init__(self, num_classes: int, embedding_dim: int = 64, z_dim: int = 8,
                 obj_size: int = 32, fusion: str = "transformer", conv_dim: int = 64):
        super().__init__()
        self.z_dim, self.obj_size, self.fusion = z_dim, obj_size, fusion
        self.crop_encoder = CropEncoder(num_classes, conv_dim, z_dim)
        self.layout_encoder = LayoutEncoder(num_classes, conv_dim, z_dim, embedding_dim,
                                            fusion=fusion)
        self.decoder = Decoder(conv_dim)

    def sample(self, labels: torch.Tensor, boxes: torch.Tensor, masks: torch.Tensor,
               z_rand: torch.Tensor) -> torch.Tensor:
        """Layout-to-image sampling: the layout encoder and the decoder on
        random z, no input image (the reference's ``img_rand`` pathway,
        ``generator_app.py:920-923``); the module should be in eval mode.
        masks (b, o, 64, 64) (``ops.bbox.bbox_mask``) -> (b, 3, 64, 64)."""
        valid = (labels != 0).to(masks.dtype)
        return self.decoder(self.layout_encoder(labels, masks, z_rand, valid))

    def forward(self, images: torch.Tensor, labels: torch.Tensor, boxes: torch.Tensor,
                masks: torch.Tensor, z_rand: torch.Tensor, eps_real: torch.Tensor,
                eps_rand: torch.Tensor, deterministic: bool = True) -> dict[str, torch.Tensor]:
        """images (b, 3, 64, 64); labels (b, o); boxes (b, o, 4) xywh; masks
        (b, o, 64, 64); z_rand, eps_real, eps_rand (b, o, z_dim) standard
        normal (eps_*: the VAE noise of the real crops' and the random
        image's crops' encodings) -> the reference's 8-tuple as a dict, and
        ``valid``. The calls run in the JAX forward's order, which is the
        order the BN running statistics fold in."""
        valid = (labels != 0).to(torch.float32)
        crops_input = crop_boxes(images, boxes, self.obj_size)
        z_rec, mu, logvar = self.crop_encoder(crops_input, labels, valid, eps_real)
        h_rec = self.layout_encoder(labels, masks, z_rec, valid, deterministic)
        h_rand = self.layout_encoder(labels, masks, z_rand, valid, deterministic)
        img_rec = self.decoder(h_rec)
        img_rand = self.decoder(h_rand)
        crops_rand = crop_boxes(img_rand, boxes, self.obj_size)
        _, z_rand_rec, _ = self.crop_encoder(crops_rand, labels, valid, eps_rand)
        return {"crops_input": crops_input,
                "crops_input_rec": crop_boxes(img_rec, boxes, self.obj_size),
                "crops_rand": crops_rand, "img_rec": img_rec, "img_rand": img_rand, "mu": mu,
                "logvar": logvar, "z_rand_rec": z_rand_rec, "valid": valid}


class _PlainBlock(nn.Module):
    """OptimizedBlock (``pre_activation=False``) or ResidualBlock, optionally
    with spectral norm (``discriminator_app.py:29-99``). The residual
    block's conv1 keeps the input width."""

    def __init__(self, in_ch: int, out_ch: int, downsample: bool = False,
                 pre_activation: bool = True, spectral: bool = True):
        super().__init__()
        self.downsample, self.pre_activation = downsample, pre_activation

        def conv(cin: int, cout: int, k: int) -> nn.Module:
            return SNConv(cin, cout, k) if spectral else nn.Conv2d(cin, cout, k, padding=k // 2)

        mid = in_ch if pre_activation else out_ch
        self.conv1 = conv(in_ch, mid, 3)
        self.conv2 = conv(mid, out_ch, 3)
        self.sc = conv(in_ch, out_ch, 1) if (in_ch != out_ch or downsample) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.relu() if self.pre_activation else x
        h = self.conv2(self.conv1(h).relu())
        if self.downsample:
            h = F.avg_pool2d(h, 2)
        sc = x
        if self.sc is not None:
            if self.pre_activation:
                sc = self.sc(sc)
                if self.downsample:
                    sc = F.avg_pool2d(sc, 2)
            else:
                if self.downsample:
                    sc = F.avg_pool2d(sc, 2)
                sc = self.sc(sc)
        return h + sc


def _dense(cin: int, cout: int, spectral: bool, bias: bool = True) -> nn.Module:
    return SNDense(cin, cout, bias=bias) if spectral else nn.Linear(cin, cout, bias=bias)


class Layout2ImImageDiscriminator(nn.Module):
    """64px image critic (``discriminator_app.py:102-132``) -> (b,) scores."""

    def __init__(self, conv_dim: int = 64, spectral: bool = True):
        super().__init__()
        cd = conv_dim
        self.block1 = _PlainBlock(3, cd, True, pre_activation=False, spectral=spectral)
        for i, (cin, cout) in enumerate(((cd, 2 * cd), (2 * cd, 4 * cd), (4 * cd, 8 * cd),
                                         (8 * cd, 16 * cd))):
            self.add_module(f"block{i + 2}", _PlainBlock(cin, cout, True, spectral=spectral))
        self.classifier = _dense(16 * cd, 1, spectral, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        h = images
        for i in range(1, 6):
            h = getattr(self, f"block{i}")(h)
        return self.classifier(h.relu().sum(dim=(2, 3)))[..., 0]


class Layout2ImObjectDiscriminator(nn.Module):
    """Object critic, AC-GAN classifier and Gram appearance head
    (``discriminator_app.py:135-187``) on padded (b, o) crops. The
    reference's unused ``l_y`` projection embedding is left out, as in the
    JAX package."""

    def __init__(self, num_classes: int, conv_dim: int = 64, spectral: bool = True):
        super().__init__()
        cd = conv_dim
        self.app_block1 = _PlainBlock(3, cd, False, pre_activation=False, spectral=spectral)
        self.app_block2 = _PlainBlock(cd, 2 * cd, True, spectral=spectral)
        self.l_y_app = (SNEmbed(num_classes, 2 * cd) if spectral
                        else nn.Embedding(num_classes, 2 * cd))
        self.app = _dense(4 * cd, 1, spectral)
        self.block1 = _PlainBlock(3, cd, False, pre_activation=False, spectral=spectral)
        for i, (cin, cout) in enumerate(((cd, 2 * cd), (2 * cd, 4 * cd), (4 * cd, 8 * cd),
                                         (8 * cd, 16 * cd))):
            self.add_module(f"block{i + 2}", _PlainBlock(cin, cout, True, spectral=spectral))
        self.classifier_src = _dense(16 * cd, 1, spectral)
        self.classifier_cls = _dense(16 * cd, num_classes, spectral)

    def forward(self, crops: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        """crops (b, o, 3, s, s); labels (b, o) -> {"object": (b, o),
        "class_logits": (b, o, classes), "app": (b, o)}."""
        b, o = labels.shape
        x = crops.reshape(b * o, *crops.shape[2:])
        lab = labels.reshape(-1)
        a = self.app_block2(self.app_block1(x)).relu()
        n, c = a.shape[:2]
        af = a.reshape(n, c, -1)
        gram = af @ af.transpose(1, 2) / c  # (n, c, c)
        app_y = self.l_y_app(lab)[:, None, :].expand(n, c, c)
        out_app = self.app(torch.cat([gram, app_y], dim=-1))[..., 0]  # (n, c)
        h = x
        for i in range(1, 6):
            h = getattr(self, f"block{i}")(h)
        h = h.relu().sum(dim=(2, 3))
        return {"object": self.classifier_src(h)[..., 0].reshape(b, o),
                "class_logits": self.classifier_cls(h).reshape(b, o, -1),
                "app": (out_app.sum(dim=1) / c).reshape(b, o)}
