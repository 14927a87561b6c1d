"""The plain reference networks: the LostGAN-family generator (the Ours-D
context preset and its siblings with stage masks and a v2 mask trunk), the
128 px layout discriminator with its app head, and VGG19 to relu5_1.

Written from the published architecture (LostGAN-V2, "Attribute-guided
layout-to-image"), in f32, with state-dict names equal to the port's, so
one seeded dict loads into both. No kernel, no cache, no mixed precision:
training mode means batch-statistics BN and one spectral-norm power
iteration per call, as in the published code. ``set_precision`` switches
the rounding of every product's operands (``ops.Quantizer``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops, shard

BN_MOMENTUM = 0.1


class _Q(nn.Module):
    q: ops.Quantizer = ops.F32


def set_precision(net: nn.Module, q: ops.Quantizer) -> nn.Module:
    for m in net.modules():
        if isinstance(m, _Q):
            m.q = q
    return net


class BatchNorm(nn.Module):
    """BN over NCHW; training: batch mean and biased variance
    ``max(E[x^2] - mean^2, 0)``, running statistics folded with momentum 0.1
    (variance unbiased)."""

    def __init__(self, n: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(n))
            self.bias = nn.Parameter(torch.zeros(n))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if not self.training:
            return self.running_mean, self.running_var
        ranks = shard.current()
        n = x.numel() // x.shape[1] * ranks.world
        if ranks.world == 1:
            mean = x.mean(dim=(0, 2, 3))
            var = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        else:  # the global batch's statistics (shard.py)
            sums = ranks.sum(torch.stack([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3))]))
            mean = sums[0] / n
            var = (sums[1] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.stats(x)
        y = (x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = (x - mean).square().mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class _SN(_Q):
    """A weight divided by its largest singular value, estimated from the
    stored left vector u: in training one power iteration per call updates u
    first (``v = normalize(W^T u)``, ``u = normalize(W v)``, sigma = u W v)."""

    def __init__(self, shape: tuple[int, ...], bias: bool, eps: float):
        super().__init__()
        self.eps = eps
        self.weight_orig = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        self.register_buffer("weight_u", torch.empty(shape[0]))
        self.register_buffer("weight_v", torch.empty(math.prod(shape[1:])))

    def weight(self) -> torch.Tensor:
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        u = self.weight_u
        with torch.no_grad():
            v = F.normalize(w_mat.T @ u, dim=0, eps=self.eps)
            if self.training:
                u = F.normalize(w_mat @ v, dim=0, eps=self.eps)
                self.weight_u.copy_(u)
                v = v.clone()
                u = u.clone()
        return w / (u @ (w_mat @ v))


class SNLinear(_SN):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__((n_out, n_in), bias, 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.linear(x, self.weight(), self.bias, self.q)


class SNConv(_SN):
    def __init__(self, c_in: int, c_out: int, k: int = 3):
        super().__init__((c_out, c_in, k, k), True, 1e-4)
        self.pad = k // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv2d(x, self.weight(), self.bias, self.pad, self.q)


class SNEmbed(_SN):
    def __init__(self, n: int, dim: int):
        super().__init__((n, dim), False, 1e-12)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight()[idx]


class Conv(_Q):
    def __init__(self, c_in: int, c_out: int, k: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv2d(x, self.weight, self.bias, self.weight.shape[-1] // 2, self.q)


class Linear(_Q):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.linear(x, self.weight, self.bias, self.q)


class Dropout:
    """Feature dropout as the program draws it: ``bernoulli_(1 - p) / (1 - p)``
    per (row, channel) from torch's default generator of x's device, drawn
    in ``dtype`` (the configuration's compute type) for the global batch and
    applied in f32 to this rank's rows."""

    def __init__(self, p: float, dtype: torch.dtype):
        self.p, self.dtype = p, dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ranks = shard.current()
        shape = (x.shape[0] * ranks.world, x.shape[1]) + (1,) * (x.ndim - 2)
        noise = torch.empty(shape, dtype=self.dtype, device=x.device).bernoulli_(1.0 - self.p)
        return x * ranks.rows(noise.div_(1.0 - self.p)).to(x.dtype)


# ---- generator ----

class BoxAttention(_Q):
    """One-head attention over the object vectors with the box-geometry
    term ``log(max(relu(W_G geo), 1e-6))`` added to the logits; pad keys
    masked; two residual LayerNorms."""

    def __init__(self, d: int):
        super().__init__()
        self.d = d
        self.linears = nn.ModuleList(Linear(d, d) for _ in range(4))
        self.WGs = nn.ModuleList([Linear(64, 1)])
        self.layer_norm0 = nn.LayerNorm(d, eps=1e-5)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        q, k, v = (lin(x) for lin in self.linears[:3])
        logits = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(self.d)
        logits = logits.masked_fill((labels == 0)[:, None, :], -1e9)
        w_g = torch.relu(self.WGs[0](ops.box_relation(boxes)))[..., 0]
        attn = torch.softmax(torch.log(torch.clamp_min(w_g, 1e-6)) + logits, dim=-1)
        out = self.layer_norm0(self.q(attn) @ self.q(v) + x)
        return self.layer_norm(self.linears[3](out) + out)


class MaskRegress(nn.Module):
    """The v2 mask trunk: SN fc to 256x4x4, (SNConv, InstanceNorm, ReLU) x3
    with bilinear 2x resizes, a 1x1 SNConv and a sigmoid; 16x16 masks
    splatted into the boxes on a ``map_size`` canvas."""

    def __init__(self, num_w: int, map_size: int = 64, ch: int = 256):
        super().__init__()
        self.ch, self.map_size = ch, map_size
        self.fc = SNLinear(num_w, ch * 16)
        self.conv1 = nn.ModuleList([SNConv(ch, ch, 3)])
        self.conv2 = nn.ModuleList([SNConv(ch, ch, 3)])
        self.conv3 = nn.ModuleDict({"0": SNConv(ch, ch, 3), "3": SNConv(ch, 1, 1)})

    def forward(self, w: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        b, o, _ = w.shape
        x = self.fc(w).reshape(b * o, self.ch, 4, 4)
        x = ops.resize_bilinear(F.relu(instance_norm(self.conv1[0](x))), (8, 8))
        x = ops.resize_bilinear(F.relu(instance_norm(self.conv2[0](x))), (16, 16))
        x = torch.sigmoid(self.conv3["3"](F.relu(instance_norm(self.conv3["0"](x)))))
        return ops.masks_to_layout(boxes, x.reshape(b, o, 16, 16), self.map_size)


class ISLANorm(nn.Module):
    def __init__(self, c: int, num_w: int):
        super().__init__()
        self.weight_proj = SNLinear(num_w, c)
        self.bias_proj = SNLinear(num_w, c)
        self.batch_norm2d = BatchNorm(c, affine=False)
        self.calls: list | None = None  # set to a list to record each call's shapes

    def forward(self, x, w, mask, relu=True):
        if self.calls is not None:
            self.calls.append((tuple(x.shape), tuple(mask.shape)))
        mean, var = self.batch_norm2d.stats(x)
        return ops.isla_norm(x, mean, var, self.batch_norm2d.eps, mask, self.weight_proj(w),
                             self.bias_proj(w), relu)


class PSP(nn.Module):
    """Pyramid pooling (1, 2, 3, 6) to ``out`` channels each, bilinear back
    (align_corners), a 3x3 bottleneck, then feature dropout (p 0.1)."""

    def __init__(self, c: int, out: int, dropout: Dropout):
        super().__init__()
        self.sizes = (1, 2, 3, 6)
        self.stages = nn.ModuleList(
            nn.ModuleDict({"1": Conv(c, out, 1, bias=False), "2": BatchNorm(out)})
            for _ in self.sizes)
        self.bottleneck = nn.ModuleDict({"0": Conv(c + 4 * out, out, 3, bias=False),
                                         "1": BatchNorm(out)})
        self.dropout = dropout

    def forward(self, x: torch.Tensor, live: bool) -> torch.Tensor:
        hw = tuple(x.shape[-2:])
        priors = [ops.resize_bilinear(F.relu(st["2"](st["1"](F.adaptive_avg_pool2d(x, s)))),
                                      hw, align_corners=True)
                  for s, st in zip(self.sizes, self.stages)]
        y = F.relu(self.bottleneck["1"](self.bottleneck["0"](torch.cat([*priors, x], dim=1))))
        return self.dropout(y) if live else y


class GenBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, num_w: int, head: str, classes: int,
                 dropout: Dropout):
        super().__init__()
        self.b1 = ISLANorm(c_in, num_w)
        self.conv1 = SNConv(c_in, c_out, 3)
        self.b2 = ISLANorm(c_out, num_w)
        self.conv2 = SNConv(c_out, c_out, 3)
        self.c_sc = SNConv(c_in, c_out, 1)
        self.head = head
        if head == "psp":
            self.conv_mask = nn.ModuleList([PSP(c_out, 100, dropout), Conv(100, classes, 1)])
        elif head == "conv":
            self.conv_mask = nn.ModuleDict({"0": Conv(c_out, 100, 3), "1": BatchNorm(100),
                                            "3": Conv(100, classes, 1)})

    def forward(self, x, w, mask, live):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        y = self.conv2(self.b2(self.conv1(up(self.b1(x, w, mask))), w, mask))
        out = y + self.c_sc(up(x))
        if self.head == "psp":
            return out, self.conv_mask[1](self.conv_mask[0](out, live))
        if self.head == "conv":
            cm = self.conv_mask
            return out, cm["3"](F.relu(cm["1"](cm["0"](out))))
        return out, None


class Generator(nn.Module):
    """The stage-mask generator with box attention (``ours_d_context128``
    at ch=64, 128 px): 4x4 start from z_im, five upsampling ISLA ResBlocks,
    per-class stage masks gated by learned alphas, a PSP head on the fourth
    block, and a BN-ReLU-SNConv-tanh RGB head."""

    def __init__(self, num_classes: int, ch: int = 64, z_dim: int = 128, emb_dim: int = 180,
                 mask_classes: int = 184, map_size: int = 64,
                 dropout_dtype: torch.dtype = torch.float32):
        super().__init__()
        num_w = z_dim + emb_dim
        self.ch, self.map_size = ch, map_size
        self.label_embedding = nn.Embedding(num_classes, emb_dim)
        self.context = BoxAttention(num_w)
        self.mask_regress = MaskRegress(num_w, map_size)
        self.fc = SNLinear(z_dim, 16 * 16 * ch)
        mults = [16, 16, 8, 4, 2, 1]
        drop = Dropout(0.1, dropout_dtype)
        self.n_blocks = 5
        for i in range(self.n_blocks):
            head = "psp" if i == 3 else ("conv" if i < 3 else "none")
            self.add_module(f"res{i + 1}", GenBlock(mults[i] * ch, mults[i + 1] * ch, num_w, head,
                                                    mask_classes, drop))
            if i < 4:
                self.register_parameter(f"alpha{i + 1}",
                                        nn.Parameter(torch.zeros(1, mask_classes, 1)))
        self.final = nn.ModuleDict({"0": BatchNorm(ch), "2": SNConv(ch, 3, 3)})

    def forward(self, z, boxes, labels, z_im, live_dropout: bool):
        b, o = labels.shape
        w = torch.cat([z, self.label_embedding(labels)], dim=-1)
        w = self.context(w, boxes, labels)
        bmask = self.mask_regress(w, boxes)
        x = self.fc(z_im).reshape(b, 16 * self.ch, 4, 4)
        stage = bmask
        hard = ops.bbox_mask(boxes, self.map_size, self.map_size)
        for i in range(self.n_blocks):
            x, smask = getattr(self, f"res{i + 1}")(x, w, stage, live_dropout)
            if smask is None:
                continue
            hh, ww = smask.shape[-2:]
            idx = labels[:, :, None, None].expand(b, o, hh, ww)
            seman = torch.sigmoid(smask.gather(1, idx)) * ops.resize_nearest(hard, (hh, ww))
            alpha = torch.sigmoid(getattr(self, f"alpha{i + 1}").reshape(-1))[labels][..., None, None]
            stage = ops.resize_bilinear(bmask, (hh, ww)) * (1 - alpha) + seman * alpha
        return torch.tanh(self.final["2"](F.relu(self.final["0"](x))))


# ---- discriminator ----

class DBlock(nn.Module):
    """SN ResBlock of D: pre-activation (``first``: none, shortcut after the
    pool), 2x2 average pool when ``down``."""

    def __init__(self, c_in: int, c_out: int, down: bool, first: bool = False):
        super().__init__()
        self.down, self.first = down, first
        self.conv1 = SNConv(c_in, c_out, 3)
        self.conv2 = SNConv(c_out, c_out, 3)
        self.c_sc = SNConv(c_in, c_out, 1) if (first or c_in != c_out or down) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.first:
            y = self.conv2(F.relu(self.conv1(x)))
            if self.down:
                y, x = F.avg_pool2d(y, 2), F.avg_pool2d(x, 2)
            return y + self.c_sc(x)
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.down:
            y = F.avg_pool2d(y, 2)
        sc = x
        if self.c_sc is not None:
            sc = self.c_sc(sc)
            if self.down:
                sc = F.avg_pool2d(sc, 2)
        return y + sc


class Discriminator(_Q):
    """The 128 px layout discriminator: image trunk and score, dual-scale
    RoIAlign (boxes under 64 px from the 1/4 map through ``block_obj3`` and
    ``block_obj4``, the rest from the 1/8 map through ``block_obj4``),
    ``block_obj5`` and a class-projection object score, and with
    ``app_head`` the Gram-matrix appearance score of the crops."""

    def __init__(self, num_classes: int, ch: int = 64, app_head: bool = True):
        super().__init__()
        self.app_head = app_head
        trunk = [(3, ch, True), (ch, 2 * ch, True), (2 * ch, 4 * ch, True), (4 * ch, 8 * ch, True),
                 (8 * ch, 16 * ch, True), (16 * ch, 16 * ch, False)]
        for i, (cin, cout, down) in enumerate(trunk):
            self.add_module(f"block{i + 1}", DBlock(cin, cout, down, first=i == 0))
        self.l7 = SNLinear(16 * ch, 1)
        self.block_obj3 = DBlock(2 * ch, 4 * ch, False)
        self.block_obj4 = DBlock(4 * ch, 8 * ch, False)
        self.block_obj5 = DBlock(8 * ch, 16 * ch, True)
        self.l_obj = SNLinear(16 * ch, 1)
        self.l_y = SNEmbed(num_classes, 16 * ch)
        if app_head:
            self.app_conv = DBlock(8 * ch, 8 * ch, False)
            self.l_y_app = SNEmbed(num_classes, 8 * ch)
            self.app = SNLinear(16 * ch, 1)

    def forward(self, images, boxes, labels):
        b, o = labels.shape
        x0, y0, bw, bh = boxes.unbind(-1)
        boxes_px = torch.stack([x0, y0, x0 + bw, y0 + bh], dim=-1) * 128
        feats, x = [], images
        for i in range(6):
            x = getattr(self, f"block{i + 1}")(x)
            feats.append(x)
        out = {"image": self.l7(F.relu(feats[-1]).sum(dim=(2, 3)))}
        obj_s = self.block_obj4(self.block_obj3(feats[1]))
        obj_l = self.block_obj4(feats[2])
        crops = ops.dual_scale_roi_align(obj_s, obj_l, boxes_px, 8, 1 / 4, 1 / 8, 64.0)
        of = crops.reshape(b * o, *crops.shape[2:])
        flat = labels.reshape(-1)
        if self.app_head:
            out["app"] = self._app(of, flat).reshape(b, o)
        of = F.relu(self.block_obj5(of)).sum(dim=(2, 3))
        out["object"] = (self.l_obj(of)[..., 0] + (self.l_y(flat) * of).sum(dim=-1)).reshape(b, o)
        return out

    def _app(self, of: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        app = F.relu(self.app_conv(of))
        n, c = app.shape[:2]
        appf = self.q(app.reshape(n, c, -1))
        gram = appf @ appf.transpose(1, 2) / c
        # app(cat([gram, app_y])), the label half applied once per object
        # rather than to c copies of its row (the same sums, no (n, c, 2c) cat)
        w = self.app.weight()
        app_y = ops.linear(self.l_y_app(flat), w[:, c:], None, self.q)  # (n, 1)
        score = ops.linear(gram, w[:, :c], self.app.bias, self.q)[..., 0] + app_y
        return score.sum(dim=1) / c


# ---- VGG19 perceptual loss ----

VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512]
VGG_TAPS = (1, 6, 11, 20, 29)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class VGG(nn.Module):
    """torchvision's VGG19 ``features`` to relu5_1 (names ``features.{i}``)."""

    def __init__(self):
        super().__init__()
        layers, c = {}, 3
        i = 0
        for item in VGG19:
            if item == "M":
                i += 1
            else:
                layers[str(i)] = Conv(c, item, 3)
                c = item
                i += 2
        self.features = nn.ModuleDict(layers)

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        out, i = [], 0
        for item in VGG19:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                i += 1
                continue
            x = F.relu(self.features[str(i)](x))
            if i + 1 in VGG_TAPS:
                out.append(x)
            i += 2
        return out

    def loss(self, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        f = self.taps(fake)
        with torch.no_grad():
            r = self.taps(real)
        return sum(w * (a - b).abs().mean() for w, a, b in zip(VGG_WEIGHTS, f, r))
