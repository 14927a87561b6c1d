"""The modules the remaining LostGAN presets add to the port, against the JAX
package's, on the CPU.

- ``SpatialAdaptiveNorm`` with 3 part masks (``context128_part``): the port
  makes one ISLA call per part (the kernels take one mask per object) and
  sums them before the ReLU. In f32, in training (batch statistics), with a
  pad object (all-zero masks) among the objects: the output and the
  gradients of x (through the batch statistics), the style vectors and the
  masks against ``jax.grad`` at 1e-5 of each one's largest element. In
  bf16, against the port's own f32 norm from the same bf16-rounded inputs
  and weights: each part's output is rounded to bf16 once and the sum of
  three rounds twice more, where JAX's one expression rounds once, so the
  bar is three times the one-call bar of the kernel checks (1e-2 of
  max|f32|): 3e-2 of max|f32|.
- ``MaskRegressNet``, the v1 trunk (128 channels, batch-statistics BN over
  all b*o slots, pad slots included), with 1 and 3 parts: its layouts in
  eval and in training at 1e-5, and the BN running statistics after the
  training call at 1e-5.
- ``GraphFunc``, the GCN context: the adjacency, the deterministic output at
  1e-5, and its dropout (0.5, elementwise) live only when
  ``deterministic=False``.
- The ISLA kernels' 32-bit indexing at the 256px generator's shapes: every
  buffer under 2^31 elements up to b=128, and the wrappers' guard raises
  at 2^31.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from layout2img_tpu.nn.gcn import GraphFunc as JaxGraphFunc
from layout2img_tpu.nn.gcn import same_label_adjacency as jax_same_label_adjacency
from layout2img_tpu.nn.mask_regress import MaskRegressNet as JaxMaskRegressNet
from layout2img_tpu.nn.norms import SpatialAdaptiveNorm as JaxSpatialAdaptiveNorm
from layout2img_tpu_torch.data.synthetic import PAD_BOX
from layout2img_tpu_torch.nn.gcn import GraphFunc, same_label_adjacency
from layout2img_tpu_torch.nn.mask_regress import MaskRegressNet
from layout2img_tpu_torch.nn.norms import SpatialAdaptiveNorm
from layout2img_tpu_torch.ops.isla import _check_int32, backward_config
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

B, O, NUM_W, P = 2, 5, 12, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _rel_close(got, want, rtol, what=""):
    want = np.asarray(want)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _part_masks(rng, hs: int) -> np.ndarray:
    """(b, o, P, hs, hs): objects 0-3 non-zero inside a box per part
    (overlapping), object 4 a pad (all zero)."""
    mask = np.zeros((B, O, P, hs, hs), np.float32)
    for i in range(B):
        for j in range(O - 1):
            for p in range(P):
                y0, x0 = rng.integers(0, hs // 2, 2)
                y1, x1 = rng.integers(hs // 2 + 1, hs + 1, 2)
                mask[i, j, p, y0:y1, x0:x1] = rng.uniform(0.05, 1.0, (y1 - y0, x1 - x0))
    return mask


def _load_sn_dense(proj, params, spectral):
    with torch.no_grad():
        proj.weight_orig.copy_(_t(params["kernel"].T))
        proj.bias.copy_(_t(params["bias"]))
        proj.weight_u.copy_(_t(spectral["u"]))


@pytest.fixture(scope="module")
def part_norm():
    """(JAX module, variables, x, vectors, mask, cotangent, port norm)."""
    rng = np.random.default_rng(21)
    c, h, hs = 8, 16, 8
    x = rng.standard_normal((B, h, h, c)).astype(np.float32) * 1.5 + 0.2
    vectors = rng.standard_normal((B, O, NUM_W)).astype(np.float32)
    mask = _part_masks(rng, hs)
    cot = rng.standard_normal((B, h, h, c)).astype(np.float32)
    jn = JaxSpatialAdaptiveNorm()
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jn.init(jax.random.PRNGKey(4), x, vectors, mask)))
    norm = SpatialAdaptiveNorm(c, NUM_W, parts=P).train()
    for name in ("weight_proj", "bias_proj"):
        _load_sn_dense(getattr(norm, name), variables["params"][name], variables["spectral"][name])
    return jn, variables, x, vectors, mask, cot, norm


def test_part_norm_matches_jax_f32(part_norm):
    jn, variables, x, vectors, mask, cot, norm = part_norm
    assert norm.weight_proj.weight_orig.shape == (P * x.shape[-1], NUM_W)

    def loss(x, vectors, mask):
        out, _ = jn.apply(variables, x, vectors, mask, use_running_average=False,
                          update_spectral=True, mutable=["batch_stats", "spectral"])
        out = jax.nn.relu(out)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        x, vectors, mask)
    leaves = [_t(_nchw(x)).requires_grad_(True), _t(vectors).requires_grad_(True),
              _t(mask).requires_grad_(True)]
    out = norm(*leaves, relu=True)
    _rel_close(out, _nchw(want), 1e-5, "out")
    got = torch.autograd.grad((out * _t(_nchw(cot))).sum(), leaves)
    for name, g, w in zip(("x", "vectors", "mask"), got, grads):
        _rel_close(g, _nchw(w) if name == "x" else w, 1e-5, name)
    # the pad object weighs nothing: its gamma and beta get no gradient
    assert float(np.abs(np.asarray(grads[1])[:, O - 1]).max()) == 0.0
    assert got[1][:, O - 1].abs().max().item() == 0.0


def test_part_norm_is_three_isla_calls(part_norm, monkeypatch):
    """One ISLA call per part, each with contiguous slices and no ReLU."""
    from layout2img_tpu_torch.nn import norms

    _, _, x, vectors, mask, _, norm = part_norm
    calls, real = [], norms.isla_norm

    def rec(x, mean, var, eps, m, gamma, beta, relu=False, **window):
        calls.append((tuple(m.shape), m.is_contiguous(), gamma.is_contiguous(), relu))
        return real(x, mean, var, eps, m, gamma, beta, relu=relu, **window)

    monkeypatch.setattr(norms, "isla_norm", rec)
    with torch.no_grad():
        norm.eval()(_t(_nchw(x)), _t(vectors), _t(mask), relu=True)
    norm.train()
    assert calls == [((B, O) + mask.shape[3:], True, True, False)] * P


def test_part_norm_bf16_bar(part_norm):
    _, _, x, vectors, mask, _, norm = part_norm
    args = [_t(_nchw(x)), _t(vectors), _t(mask)]
    half = SpatialAdaptiveNorm(x.shape[-1], NUM_W, parts=P).eval()
    half.load_state_dict(norm.state_dict())
    half.to(torch.bfloat16)
    full = SpatialAdaptiveNorm(x.shape[-1], NUM_W, parts=P).eval()
    full.load_state_dict({k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
                          for k, v in norm.state_dict().items()})
    with torch.no_grad():
        got = half(*(a.to(torch.bfloat16) for a in args), relu=True)
        want = full(*(a.to(torch.bfloat16).float() for a in args), relu=True)
    assert got.dtype == torch.bfloat16
    err, scale = (got.float() - want).abs().max().item(), want.abs().max().item()
    assert err <= 3e-2 * scale, (err, scale)


def _boxes(rng):
    xy = rng.uniform(0, 0.5, (B, O, 2))
    wh = rng.uniform(0.1, 0.45, (B, O, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    boxes[:, -1] = PAD_BOX
    return boxes


@pytest.mark.parametrize("parts", [1, 3])
def test_mask_regress_v1_matches_jax(parts):
    rng = np.random.default_rng(22 + parts)
    vectors = rng.standard_normal((B, O, NUM_W)).astype(np.float32)
    boxes = _boxes(rng)
    jm = JaxMaskRegressNet(map_size=32, num_parts=parts)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jm.init(jax.random.PRNGKey(5), vectors, boxes, train=False)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: s + rng.uniform(0.1, 0.5, s.shape).astype(s.dtype), variables["batch_stats"])
    port = MaskRegressNet(NUM_W, map_size=32, num_parts=parts)
    p, sp, st = variables["params"], variables["spectral"], variables["batch_stats"]
    _load_sn_dense(port.fc, p["fc"], sp["fc"])
    for mine, seq, i in (("conv1", port.conv1, 0), ("conv2", port.conv2, 0),
                         ("conv3a", port.conv3, 0), ("conv3b", port.conv3, 3)):
        conv = seq[i]
        with torch.no_grad():
            conv.weight_orig.copy_(_t(p[mine]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(_t(p[mine]["bias"]))
            conv.weight_u.copy_(_t(sp[mine]["u"]))
    for mine, bn in (("bn1", port.conv1[1]), ("bn2", port.conv2[1]), ("bn3", port.conv3[1])):
        with torch.no_grad():
            bn.weight.copy_(_t(p[mine]["scale"]))
            bn.bias.copy_(_t(p[mine]["bias"]))
            bn.running_mean.copy_(_t(st[mine]["mean"]))
            bn.running_var.copy_(_t(st[mine]["var"]))
    shape = (B, O, 32, 32) if parts == 1 else (B, O, parts, 32, 32)
    want = jm.apply(variables, vectors, boxes, train=False, update_stats=False)
    with torch.no_grad():
        got = port.eval()(_t(vectors), _t(boxes))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want, new = jm.apply(variables, vectors, boxes, train=True, update_stats=True,
                         mutable=["batch_stats", "spectral"])
    with torch.no_grad():
        got = port.train()(_t(vectors), _t(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for mine, bn in (("bn1", port.conv1[1]), ("bn2", port.conv2[1]), ("bn3", port.conv3[1])):
        np.testing.assert_allclose(bn.running_mean.numpy(), new["batch_stats"][mine]["mean"],
                                   atol=1e-5, rtol=0, err_msg=mine)
        np.testing.assert_allclose(bn.running_var.numpy(), new["batch_stats"][mine]["var"],
                                   atol=1e-5, rtol=0, err_msg=mine)
    # pads are in the batch statistics: a pad slot's vector moves a valid slot's mask
    moved = _t(vectors).clone()
    moved[:, -1] += 3.0
    with torch.no_grad():
        shifted = port.train()(moved, _t(boxes))
    assert (shifted[:, 0] - got[:, 0]).abs().max().item() > 1e-6


@pytest.fixture(scope="module")
def gcn():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, O, NUM_W)).astype(np.float32)
    labels = np.array([[3, 3, 4, 0, 0], [1, 2, 1, 1, 0]], np.int32)
    jg = JaxGraphFunc(NUM_W)
    variables = jax.tree_util.tree_map(np.asarray, dict(jg.init(jax.random.PRNGKey(6), x, labels)))
    port = GraphFunc(NUM_W)
    p = variables["params"]
    with torch.no_grad():
        for gc in ("gc1", "gc2"):
            getattr(port, gc).weight.copy_(_t(p[f"{gc}_w"]))
            getattr(port, gc).bias.copy_(_t(p[f"{gc}_b"]))
    return jg, variables, x, labels, port


def test_gcn_matches_jax(gcn):
    jg, variables, x, labels, port = gcn
    np.testing.assert_allclose(same_label_adjacency(_t(labels)).numpy(),
                               np.asarray(jax_same_label_adjacency(labels)), atol=0, rtol=0)
    assert port.gc1.weight.shape == (NUM_W, 4 * NUM_W)  # (in, out), as the reference stores it
    want = jg.apply(variables, x, labels, deterministic=True)
    with torch.no_grad():
        got = port(_t(x), _t(labels).long(), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gcn_dropout_only_when_not_deterministic(gcn):
    _, _, x, labels, port = gcn
    port.train()  # the module's mode does not switch it: ``deterministic`` does
    args = (_t(x), _t(labels).long())
    with torch.no_grad():
        det = port(*args, deterministic=True)
        again = port.eval()(*args, deterministic=True)
        torch.manual_seed(0)
        a = port(*args, deterministic=False)
        torch.manual_seed(0)
        b = port(*args, deterministic=False)
        torch.manual_seed(1)
        c = port(*args, deterministic=False)
    assert torch.equal(det, again)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, det)
    # about half of the hidden units dropped, the rest scaled by 2
    h = torch.relu(port.gc1(args[0], same_label_adjacency(args[1])))
    torch.manual_seed(0)
    dropped = torch.nn.functional.dropout(h, 0.5, training=True)
    share = ((dropped == 0) & (h != 0)).float().sum() / (h != 0).float().sum()
    assert 0.35 < share.item() < 0.65


@pytest.mark.parametrize("b", [8, 32, 128])
@pytest.mark.parametrize("h,c", [(128, 128), (256, 64)])
def test_buffers_fit_int32_at_256px(b, h, c):
    """x and the backward's three partial buffers of the 256px generator's
    largest norms (o=8, COCO) stay under 2^31 elements, so the wrapper's
    guard passes them."""
    o = 8
    cfg = backward_config(b, c, h, h, o, num_sms=132)
    elements = dict(x=b * c * h * h, part_stats=b * cfg.n_spans * 2 * c,
                    part_gb=b * cfg.n_spans * 2 * o * c, part_dm=cfg.n_groups * b * o * h * h)
    assert max(elements.values()) < 2**31, elements
    _check_int32(**elements)


def test_int32_guard_raises():
    _check_int32(x=2**31 - 1, batch_grid=65535 * 2**15)
    with pytest.raises(ValueError, match="32-bit"):
        _check_int32(x=2**31)
    with pytest.raises(ValueError, match="batch_grid"):
        _check_int32(batch_grid=65536 * 2**15)
