"""The port's hand-written GPU kernels against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Forward bars: f32 at 1e-5 * max|plain| (the kernel and the plain version
differ in summation order and in folding 1/d into the mask); bf16 at
1e-2 * max|plain| (the plain version rounds the BN output and the resized
mask to bf16, the kernel keeps both in f32). The backward's bars are stated
in its tests.
"""

import pytest
import torch

from layout2img_tpu_torch.nn.norms import batch_stats
from layout2img_tpu_torch.ops import _build
from layout2img_tpu_torch.ops.isla import (BackwardConfig, _launch_backward, _launch_finish,
                                           backward_config, finish_backward_plain, isla_norm,
                                           isla_norm_backward, isla_norm_plain)

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, o, c, hw, src_hw, dtype, device, pattern="sparse"):
    """x (b, c, *hw), f32 running statistics, the source mask (b, o, *src_hw),
    gamma and beta. ``sparse``: the first half of the objects each cover a
    random box, the rest are pad objects with all-zero masks; ``dense``:
    every object is non-zero everywhere."""
    gen = torch.Generator().manual_seed(seed)
    hs, ws = src_hw
    if pattern == "dense":
        mask = torch.rand(b, o, hs, ws, generator=gen) + 0.01
    else:
        mask = torch.zeros(b, o, hs, ws)
        for i in range(b):
            for j in range(max(o // 2, 1)):
                y0, x0 = (int(torch.randint(0, n // 2 + 1, (), generator=gen)) for n in (hs, ws))
                y1 = int(torch.randint(y0 + 1, hs + 1, (), generator=gen))
                x1 = int(torch.randint(x0 + 1, ws + 1, (), generator=gen))
                mask[i, j, y0:y1, x0:x1] = torch.rand(y1 - y0, x1 - x0, generator=gen)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)

    mean = (torch.randn(c, generator=gen) * 0.5).to(device)
    var = (torch.rand(c, generator=gen) + 0.5).to(device)
    return (rand(b, c, *hw), mean, var, 1e-5, mask.to(device=device, dtype=dtype),
            rand(b, o, c), rand(b, o, c))


def _check_against_plain(args, relu):
    before = isla_norm.launches
    got = isla_norm(*args, relu=relu)
    torch.cuda.synchronize()
    assert isla_norm.launches == before + 1
    x = args[0]
    assert got.dtype == x.dtype and got.shape == x.shape
    ref = isla_norm_plain(*args, relu=relu).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[x.dtype] * ref.abs().max().item(), err
    return got


# (b, c, (h, w), (hs, ws)): the ten norms of one Ours-D 128px forward, each
# with its real source mask, then odd sizes and non-integer ratios
SHAPES = [(8, 1024, (4, 4), (64, 64)), (8, 1024, (8, 8), (64, 64)), (8, 1024, (8, 8), (8, 8)),
          (8, 512, (16, 16), (8, 8)), (8, 512, (16, 16), (16, 16)), (8, 256, (32, 32), (16, 16)),
          (8, 256, (32, 32), (32, 32)), (8, 128, (64, 64), (32, 32)), (8, 128, (64, 64), (64, 64)),
          (8, 64, (128, 128), (64, 64)), (2, 48, (9, 13), (5, 7)), (1, 200, (33, 17), (16, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [8, 31, 3])
@pytest.mark.parametrize("b,c,hw,src_hw", SHAPES)
def test_isla_kernel_matches_plain(cuda_device, dtype, o, b, c, hw, src_hw, relu):
    _check_against_plain(_inputs(o * c + hw[0], b, o, c, hw, src_hw, dtype, cuda_device), relu)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["sparse", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,src_hw", [SHAPES[0], SHAPES[5], SHAPES[9], SHAPES[11]])
def test_isla_kernel_sparse_and_dense_masks(cuda_device, pattern, dtype, b, c, hw, src_hw):
    """Live-object compaction depends on the data: a few objects per tile,
    or every object everywhere (the most work)."""
    _check_against_plain(_inputs(7, b, 31, c, hw, src_hw, dtype, cuda_device, pattern), True)


@pytest.mark.cuda
def test_isla_kernel_pad_objects_add_nothing(cuda_device):
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 31, 64, (16, 16), (8, 8), torch.float32,
                                                   cuda_device)
    n = 31 // 2  # the sparse pattern leaves objects n.. all zero
    assert mask[:, n:].abs().max().item() == 0.0
    full = isla_norm(x, mean, var, eps, mask, gamma, beta)
    cut = isla_norm(x, mean, var, eps, mask[:, :n].contiguous(), gamma[:, :n].contiguous(),
                    beta[:, :n].contiguous())
    torch.testing.assert_close(full, cut, rtol=0, atol=0)


@pytest.mark.cuda
def test_isla_kernel_rejects_non_contiguous(cuda_device):
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 8, 32, (8, 8), (8, 8), torch.float32,
                                                   cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        isla_norm(x.transpose(2, 3), mean, var, eps, mask, gamma, beta)


def _grads_through_stats(norm, x, mask, gamma, beta, grad, relu):
    """Gradients of x (through y and the batch statistics), mask, gamma and
    beta of ``norm`` with batch statistics computed from x."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, mask, gamma, beta)]
    mean, var = batch_stats(leaves[0])
    out = norm(leaves[0], mean, var, 1e-5, *leaves[1:], relu=relu)
    return out, torch.autograd.grad(out, leaves, grad)


# (b, c, (h, w), (hs, ws), o): odd sizes, few and many objects, and the shapes
# at both ends of one Ours-D 128px forward
BWD_SHAPES = [(2, 48, (9, 13), (5, 7), 3), (2, 48, (9, 13), (5, 7), 64), (1, 200, (33, 17), (16, 16), 8),
              (8, 1024, (4, 4), (64, 64), 31), (8, 64, (128, 128), (64, 64), 31)]


def _check_backward(cuda_device, dtype, b, c, hw, src_hw, o, relu, pattern):
    """The backward through ``isla_norm`` against autograd of the plain
    version; bars in ``test_isla_backward_matches_plain_autograd``."""
    x, _, _, _, mask, gamma, beta = _inputs(o * c + hw[0], b, o, c, hw, src_hw, dtype, cuda_device,
                                            pattern)
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(cuda_device, dtype)
    if relu:
        pre = isla_norm_plain(x.float(), *batch_stats(x), 1e-5, mask.float(),
                              gamma.float(), beta.float())
        grad = grad.masked_fill(pre.abs() <= 1e-5 * pre.abs().max(), 0)
    before = (isla_norm.launches, isla_norm_backward.launches)
    out, got = _grads_through_stats(isla_norm, x, mask, gamma, beta, grad, relu)
    torch.cuda.synchronize()
    assert (isla_norm.launches, isla_norm_backward.launches) == (before[0] + 1, before[1] + 1)
    _, want = _grads_through_stats(isla_norm_plain, *(t.float() for t in (x, mask, gamma, beta, grad)),
                                   relu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("x", "mask_src", "gamma", "beta"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,src_hw,o", BWD_SHAPES)
def test_isla_backward_matches_plain_autograd(cuda_device, dtype, b, c, hw, src_hw, o, relu):
    """Every gradient of the fused norm with batch statistics, through the
    backward kernel, against autograd of the plain version on the same
    inputs in f32. Bars, each against max|plain| of that gradient: 1e-4 in
    f32 (sums over up to 130k pixels in another order, and 1/d up to 1e6
    where no object covers a pixel), 2e-2 in bf16 (x, g, masks, gamma and
    beta rounded to bf16, dx rounded on the store). With the ReLU, the output
    gradient is zeroed where the output is within 1e-5 of max|output| of
    zero: there the kernel's recomputed output and the oracle's may fall on
    opposite sides of the gate."""
    _check_backward(cuda_device, dtype, b, c, hw, src_hw, o, relu, "sparse")


# the mixed step's bf16 calls at both ends of the forward, at b=128 as the
# bench runs them, with o=8 (COCO) and o=12 (VG's 31 slots cut by budgets of 12)
BENCH_SHAPES = [(128, 1024, (4, 4), (64, 64)), (128, 64, (128, 128), (64, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("o", [8, 12])
@pytest.mark.parametrize("b,c,hw,src_hw", BENCH_SHAPES)
def test_isla_bf16_at_the_bench_shapes(cuda_device, b, c, hw, src_hw, o):
    """The forward and every gradient in bf16 at the bench's batch and slot
    counts, at the bars of the tests above."""
    _check_against_plain(_inputs(o + c, b, o, c, hw, src_hw, torch.bfloat16, cuda_device), True)
    _check_backward(cuda_device, torch.bfloat16, b, c, hw, src_hw, o, True, "sparse")


# the 256px generator's last norms (a 128-px source mask), at the bench's b=32
SHAPES_256 = [(32, 128, (128, 128), (128, 128)), (32, 64, (256, 256), (128, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,src_hw", SHAPES_256)
def test_isla_at_the_256px_shapes(cuda_device, dtype, b, c, hw, src_hw):
    """The forward and every gradient at h=256 with o=8 (COCO), at the bars
    of the tests above."""
    _check_against_plain(_inputs(c, b, 8, c, hw, src_hw, dtype, cuda_device), True)
    _check_backward(cuda_device, dtype, b, c, hw, src_hw, 8, True, "sparse")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,src_hw,o", [BWD_SHAPES[1], BWD_SHAPES[3], BWD_SHAPES[4]])
def test_isla_backward_dense_masks(cuda_device, dtype, b, c, hw, src_hw, o):
    """Every object non-zero everywhere: every slot is live on every tile,
    the most work for G, B, dgamma and dbeta. Bars as above."""
    _check_backward(cuda_device, dtype, b, c, hw, src_hw, o, True, "dense")


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_isla_backward_is_bit_identical_run_to_run(cuda_device, relu):
    """Partial sums reduced in a fixed order: two launches, the same bits."""
    x, mean, var, eps, mask, gamma, beta = _inputs(3, 8, 31, 128, (64, 64), (32, 32), torch.float32,
                                                   cuda_device)
    grad = torch.randn_like(x)
    first = isla_norm_backward(x, mean, var, eps, mask, gamma, beta, grad, relu)
    second = isla_norm_backward(x, mean, var, eps, mask, gamma, beta, grad, relu)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_isla_backward_pad_objects(cuda_device):
    """Objects with all-zero masks get exactly zero dgamma and dbeta, and
    cutting them changes no other gradient by a bit. (Their mask gradient is
    not zero: growing an empty mask would change the output.)"""
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 31, 64, (16, 16), (8, 8), torch.float32,
                                                   cuda_device)
    n = 31 // 2  # the sparse pattern leaves objects n.. all zero
    grad = torch.randn_like(x)
    full = isla_norm_backward(x, mean, var, eps, mask, gamma, beta, grad, True)
    cut = isla_norm_backward(x, mean, var, eps, mask[:, :n].contiguous(), gamma[:, :n].contiguous(),
                             beta[:, :n].contiguous(), grad, True)
    dx, dmean, dvar, dmask, dgamma, dbeta = full
    assert dgamma[:, n:].abs().max().item() == 0.0 and dbeta[:, n:].abs().max().item() == 0.0
    for a, b in zip((dx, dmean, dvar, dmask[:, :n], dgamma[:, :n], dbeta[:, :n]), cut):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_isla_backward_refused_launch_raises(cuda_device):
    """A tiling whose block wants more shared memory than the card has is
    refused by the runtime; the wrapper raises instead of returning garbage."""
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 1, 64, 2048, (4, 4), (4, 4), torch.float32,
                                                   cuda_device)
    cfg = BackwardConfig(threads=256, tp=16, cc=128, n_tiles=1, tiles_per_span=1, n_spans=1,
                         n_groups=1, chunks_per_group=16, ksplit=1, smem_bytes=0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch_backward(x, mean, var, eps, mask, gamma, beta, torch.randn_like(x), False, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,src_hw,o", BWD_SHAPES + [(8, 1024, (8, 8), (8, 8), 31),
                                                      (8, 128, (64, 64), (32, 32), 31)])
def test_isla_backward_finish_matches_plain(cuda_device, dtype, b, c, hw, src_hw, o):
    """The finishing kernel against ``finish_backward_plain`` on the partial
    buffers the main kernel wrote. Bars: 1e-5 of max|plain| (sums of up to
    688 partials per channel in another order, fused multiply-adds in the
    gather); bf16 outputs also one rounding (2^-8 of each value)."""
    x, mean, var, eps, mask, gamma, beta = _inputs(o * c + hw[0], b, o, c, hw, src_hw, dtype,
                                                   cuda_device)
    grad = torch.randn_like(x)
    cfg = backward_config(b, c, *hw, o)
    _, *parts = _launch_backward(x, mean, var, eps, mask, gamma, beta, grad, True, cfg)
    before = isla_norm_backward.finish_launches
    got = _launch_finish(*parts, var, eps, mask, gamma)
    torch.cuda.synchronize()
    assert isla_norm_backward.finish_launches == before + 1
    want = finish_backward_plain(*parts, var, eps, src_hw, (torch.float32,) * 3)
    for name, a, w, dt in zip(("dmean", "dvar", "dmask", "dgamma", "dbeta"), got, want,
                              (torch.float32, torch.float32, dtype, dtype, dtype)):
        assert a.dtype == dt and a.shape == w.shape, name
        bar = 1e-5 * w.abs().max().item() + (0.0 if dt == torch.float32 else 2 ** -8) * w.abs()
        assert ((a.float() - w).abs() <= bar).all(), (name, (a.float() - w).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hw,src_hw,o", [BWD_SHAPES[0], BWD_SHAPES[3], BWD_SHAPES[4]])
def test_isla_backward_is_two_kernels(cuda_device, b, c, hw, src_hw, o):
    """One ``isla_norm_backward`` call runs exactly two kernels on the card,
    the main and the finishing one (the profiler's count), and adds one to
    each counter: ``isla_norm_backward.launches`` counts the main kernel,
    ``isla_norm_backward.finish_launches`` the finishing one."""
    from torch.profiler import ProfilerActivity, profile

    x, mean, var, eps, mask, gamma, beta = _inputs(1, b, o, c, hw, src_hw, torch.float32,
                                                   cuda_device)
    grad = torch.randn_like(x)
    isla_norm_backward(x, mean, var, eps, mask, gamma, beta, grad, True)  # build, warm up
    torch.cuda.synchronize()
    before = (isla_norm_backward.launches, isla_norm_backward.finish_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        isla_norm_backward(x, mean, var, eps, mask, gamma, beta, grad, True)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert sum("isla_norm_bwd_kernel" in k for k in kernels) == 1, kernels
    assert sum("isla_norm_bwd_finish_kernel" in k for k in kernels) == 1, kernels
    assert (isla_norm_backward.launches, isla_norm_backward.finish_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_isla_forward_under_no_grad_launches_no_backward(cuda_device):
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 8, 32, (8, 8), (8, 8), torch.float32,
                                                   cuda_device)
    gamma.requires_grad_(True)
    before = isla_norm_backward.launches
    with torch.no_grad():
        a = isla_norm(x, mean, var, eps, mask, gamma, beta)
    with torch.inference_mode():
        b = isla_norm(x, mean, var, eps, mask, gamma, beta)
    c = isla_norm(x, mean, var, eps, mask, gamma, beta)
    assert c.requires_grad and not a.requires_grad
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c.detach(), a, rtol=0, atol=0)
    assert isla_norm_backward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_isla_operators_pass_opcheck(cuda_device, dtype):
    """Both kernels as ``torch.library`` operators: schema, fake
    implementations, the autograd registration and AOT dispatch, by
    ``torch.library.opcheck`` on the card."""
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 8, 64, (8, 8), (16, 16), dtype,
                                                   cuda_device)
    grad = torch.randn_like(x)
    ops = torch.ops.layout2img_tpu_torch
    torch.library.opcheck(ops.isla_norm_backward.default,
                          (x, mean, var, eps, mask, gamma, beta, grad, True))
    for t in (x, var, mask, gamma):
        t.requires_grad_(True)
    torch.library.opcheck(ops.isla_norm.default, (x, mean, var, eps, mask, gamma, beta, True))


@pytest.mark.cuda
def test_export_keeps_the_isla_kernel(cuda_device):
    """A ``torch.export`` of the generator on the card holds the forward
    kernel's operator for each of its 10 norms and no plain-twin einsum, runs
    the kernel 10 times a call and equals the eager generator; an eager call
    after the export returns a real tensor equal to one before it."""
    from layout2img_tpu_torch.ops import interp
    from layout2img_tpu_torch.utils.convert import init_generator

    gen = init_generator(0, 184, device=cuda_device, ch=8).eval()
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 8, 128, generator=g), torch.rand(2, 8, 4, generator=g) * 0.4 + 0.1,
            torch.randint(1, 184, (2, 8), generator=g), torch.randn(2, 128, generator=g))
    args = tuple(t.to(cuda_device) for t in args)
    with torch.no_grad():
        before = gen(*args)
        interp._DEVICE_TABLES.clear()
        ep = torch.export.export(gen, args, strict=False)
        after = gen(*args)
        launches = isla_norm.launches
        got = ep.module()(*args)
        torch.cuda.synchronize()
    assert isla_norm.launches == launches + 10
    assert type(after) is torch.Tensor and torch.equal(after, before)
    nodes = list(ep.graph.nodes)
    assert sum(n.target == torch.ops.layout2img_tpu_torch.isla_norm.default for n in nodes) == 10
    assert not any(n.target == torch.ops.aten.einsum.default and n.args[0] == "bohw,boc->bchw"
                   for n in nodes)
    assert (got - before).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_build_all_builds_every_source(cuda_device):
    seconds = _build.build_all()
    assert set(seconds) == set(_build.sources())
    assert {"isla_norm", "isla_norm_bwd"} <= set(seconds)
    for name in seconds:
        assert _build.library_path(name).exists()


# ---- the data path and checkpoints on the card (no kernel of their own) ----

@pytest.mark.cuda
def test_prefetched_batches_equal_the_host_batches(cuda_device):
    """``data/prefetch.py``: pinned host memory, side-stream copies, the
    consumer stream waiting on their event; every batch arrives whole and in
    order, also while the consumer's stream is busy and buffers are freed."""
    import numpy as np

    from layout2img_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    host = [{"images": rng.standard_normal((8, 3, 128, 128), dtype=np.float32),
             "labels": rng.integers(0, 184, (8, 8)).astype(np.int32),
             "boxes": rng.random((8, 8, 4), dtype=np.float32)} for _ in range(12)]
    busy = torch.randn(4096, 4096, device=cuda_device)
    for i, batch in enumerate(device_prefetch(iter(host), cuda_device, size=2)):
        busy = busy @ busy / 64.0  # keep the consumer's stream busy while copies land
        for k, v in batch.items():
            assert v.device.type == "cuda" and v.dtype == torch.from_numpy(host[i][k]).dtype
            assert torch.equal(v.cpu(), torch.from_numpy(host[i][k])), (i, k)
        del batch
    assert i == len(host) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_on_the_card_is_bit_exact(cuda_device, tmp_path, async_save):
    """Two mixed-precision steps of a small generator and D on the card
    (Adam moments, SN vectors, BN statistics, EMA), saved, restored into a
    fresh state on the card: every tensor equal bit for bit. With
    ``AsyncSaver`` the next step's in-place update starts at once, and the
    checkpoint still holds the state of the ``save`` call."""
    import numpy as np

    from layout2img_tpu_torch.data.synthetic import synthetic_batch
    from layout2img_tpu_torch.train.checkpoint import AsyncSaver, CheckpointManager
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    cfg = TrainConfig(use_vgg_loss=False, mixed_precision=True, ema_decay=0.9)

    def fresh(seed):
        return create_train_state(
            init_generator(seed, 20, device=cuda_device, ch=16, num_mask_classes=20),
            init_discriminator(seed + 1, 20, device=cuda_device, ch=16), cfg)

    state = fresh(0)
    step = make_train_step(state, cfg)
    rng, g = np.random.default_rng(1), torch.Generator(device=cuda_device).manual_seed(2)
    batches = []
    for _ in range(3):
        b = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in synthetic_batch(rng, 4, 128, 8, 20).items()}
        b["labels"] = b["labels"].long()
        batches.append(b)
    for b in batches[:2]:
        step(b, g)
    mgr = CheckpointManager(str(tmp_path))
    saver = AsyncSaver(mgr) if async_save else mgr
    want = {k: v.detach().clone() for k, v in state.generator.state_dict().items()}
    want_opt = {k: v["exp_avg_sq"].clone() for k, v in state.g_opt.state_dict()["state"].items()}
    saver.save(state)
    step(batches[2], g)  # updates the parameters in place while the save is in flight
    saver.wait()
    other = fresh(7)
    mgr.restore(other)
    assert other.step == 2
    got = other.generator.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert all(torch.equal(other.g_opt.state_dict()["state"][k]["exp_avg_sq"], v)
               for k, v in want_opt.items())
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in other.generator.parameters())
    if not async_save:  # the synchronous save: the whole state, both Adams and the EMA
        ref = CheckpointManager(str(tmp_path / "again"))
        ref.save(other)
        a, b = ref.read(), mgr.read()
        for part in ("generator", "discriminator", "ema"):
            assert all(torch.equal(a[part][k], v) for k, v in b[part].items()), part
