"""The discriminator's 2x2 average pool with the residual add after it
(``layout2img_tpu_torch/ops/pool.py``, ``csrc/d_pool.cu``).

On the CPU: the op's plain path and its gradients are the composition of
``F.avg_pool2d`` and adds that the blocks ran before the op, bit for bit;
every downsampling site of the four D presets goes through the op
(``pool_sites`` calls a forward) and D calls ``F.avg_pool2d`` nowhere else;
the wrapper refuses what it cannot take.

On the card (marker ``cuda``; skips without one): the kernels against the
plain version at every D site shape of the benchmark's cells and of the
``d64`` and ``d256`` presets, in f32 and bf16, with and without b and r, and
on the scalar path (widths not a multiple of 8, unaligned pointers). In f32
the forward is the plain version bit for bit; in bf16 it is the plain
version computed in f32 and rounded once. The backward is ``F.avg_pool2d``'s
bit for bit, one tensor served to a and b. Then run-to-run identity,
refusals, ``torch.library.opcheck``, a row shard's window, D with
``remat_blocks`` and D's launches and profile. The file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_port_pool.py
"""

import sys

import pytest
import torch
import torch.nn.functional as F

from layout2img_tpu_torch.nn.blocks import DiscOptimizedBlock, DiscResBlock
from layout2img_tpu_torch.ops import pool
from layout2img_tpu_torch.ops.pool import pool2x2_add, pool2x2_add_plain
from layout2img_tpu_torch.utils import convert
from layout2img_tpu_torch.utils.convert import init_discriminator

VARIANTS = ["a", "ab", "ar", "abr"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs (the suite runs six
    workers on one host), as every port test file does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(variant: str, shape, dtype, device="cpu", seed: int = 0):
    """(a, b or None, r or None) of ``variant`` for a of ``shape``."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def rand(*s):
        return torch.randn(*s, generator=gen).to(device=device, dtype=dtype)

    return (rand(n, c, h, w), rand(n, c, h, w) if "b" in variant else None,
            rand(n, c, h // 2, w // 2) if "r" in variant else None)


def _composition(a, b, r):
    """What the blocks computed before the op, in their order."""
    out = F.avg_pool2d(a, 2)
    if b is not None:
        out = out + F.avg_pool2d(b, 2)
    return out if r is None else out + r


def _leaves(tensors):
    return [None if t is None else t.detach().clone().requires_grad_(True) for t in tensors]


def _grads(fn, tensors, grad):
    leaves = _leaves(tensors)
    out = fn(*leaves)
    given = [t for t in leaves if t is not None]
    return out, torch.autograd.grad(out, given, grad)


def _bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal bit for bit (the sign of zero too)."""
    assert x.dtype == y.dtype and x.shape == y.shape
    view = torch.int32 if x.dtype == torch.float32 else torch.int16
    return torch.equal(x.contiguous().view(view), y.contiguous().view(view))


# ---- the CPU path (tier 1) ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_path_and_gradients_are_the_composition(variant, dtype):
    tensors = _inputs(variant, (2, 3, 6, 10), dtype)
    grad = torch.randn(2, 3, 3, 5, generator=torch.Generator().manual_seed(9)).to(dtype)
    before = pool2x2_add.plain_calls
    got, got_g = _grads(pool2x2_add, tensors, grad)
    assert pool2x2_add.plain_calls == before + 1
    want, want_g = _grads(_composition, tensors, grad)
    assert _bits_equal(got, want)
    assert len(got_g) == len(want_g) == len(variant)
    for g, w in zip(got_g, want_g):
        assert _bits_equal(g, w)


def _parent_optimized(block, x):
    y = block.conv2(F.relu(block.conv1(x)))
    if block.downsample:
        y, x = F.avg_pool2d(y, 2), F.avg_pool2d(x, 2)
    return y + block.c_sc(x)


def _parent_res(block, x):
    y = block.conv2(F.relu(block.conv1(F.relu(x))))
    if block.downsample:
        y = F.avg_pool2d(y, 2)
    sc = x
    if block.c_sc is not None:
        sc = block.c_sc(sc)
        if block.downsample:
            sc = F.avg_pool2d(sc, 2)
    return y + sc


@pytest.mark.parametrize("kind,in_ch,out_ch,downsample",
                         [("optimized", 3, 8, True), ("optimized", 3, 8, False),
                          ("res", 4, 8, True), ("res", 8, 8, False), ("res", 4, 8, False)])
def test_blocks_equal_the_parent_composition(kind, in_ch, out_ch, downsample):
    """Each D block's output and every gradient (input and weights) against
    the blocks' code before the op, in eval mode (no power iteration, so the
    two calls see the same weights)."""
    cls, parent = ((DiscOptimizedBlock, _parent_optimized) if kind == "optimized"
                   else (DiscResBlock, _parent_res))
    block = cls(in_ch, out_ch, downsample=downsample).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        convert._init_(block, gen)
    x = torch.randn(2, in_ch, 8, 12, generator=gen)
    grads = []
    for fn in (block, lambda t: parent(block, t)):
        leaf = x.clone().requires_grad_(True)
        out = fn(leaf)
        params = [p for p in block.parameters() if p.requires_grad]
        grads.append((out, *torch.autograd.grad(out, [leaf, *params], torch.ones_like(out))))
    for g, w in zip(*grads):
        assert torch.equal(g, w)


@pytest.mark.parametrize("preset,size,sites", [("d64", 64, 4), ("d128", 128, 7),
                                               ("d128_app", 128, 7), ("d256", 256, 8)])
def test_every_d_downsampling_site_goes_through_the_op(monkeypatch, preset, size, sites):
    """``pool_sites`` op calls a forward, and ``F.avg_pool2d`` called from
    nowhere but the op's plain path (once per pooled input)."""
    callers = []
    avg_pool2d = F.avg_pool2d

    def spy(*args, **kwargs):
        callers.append(sys._getframe(1).f_code.co_filename)
        return avg_pool2d(*args, **kwargs)

    monkeypatch.setattr(F, "avg_pool2d", spy)
    disc = init_discriminator(0, 10, preset, device="cpu", ch=2).train()
    assert disc.pool_sites == sites
    gen = torch.Generator().manual_seed(1)
    images = torch.rand(2, 3, size, size, generator=gen) * 2 - 1
    boxes = torch.rand(2, 3, 4, generator=gen) * 0.5 + 0.1
    before = pool2x2_add.plain_calls
    disc(images, boxes, torch.tensor([[1, 2, 0], [3, 0, 0]]))
    assert pool2x2_add.plain_calls - before == sites
    assert callers and set(callers) == {pool.__file__}, set(callers)


@pytest.mark.parametrize("case", ["odd_h", "odd_w", "ndim", "b_shape", "r_shape", "dtype_mix",
                                  "half", "device_mix", "no_kernel"])
def test_wrapper_refuses(case):
    a = torch.randn(2, 3, 4, 6)
    b, r = torch.randn_like(a), torch.randn(2, 3, 2, 3)
    args, err, match = {
        "odd_h": ((torch.randn(2, 3, 5, 6),), ValueError, "even"),
        "odd_w": ((torch.randn(2, 3, 4, 7),), ValueError, "even"),
        "ndim": ((torch.randn(3, 4, 6),), ValueError, r"\(n, c, h, w\)"),
        "b_shape": ((a, torch.randn(2, 3, 4, 8)), ValueError, "does not match"),
        "r_shape": ((a, b, torch.randn(2, 3, 4, 6)), ValueError, "pooled size"),
        "dtype_mix": ((a, b.to(torch.bfloat16)), TypeError, "one dtype"),
        "half": ((a.half(),), TypeError, "one dtype"),
        "device_mix": ((a, b, r.to("meta")), ValueError, "different devices"),
        "no_kernel": ((a.to("meta"),), ValueError, "no kernel"),
    }[case]
    with pytest.raises(err, match=match):
        pool2x2_add(*args)


def test_kernel_checks_refuse_non_contiguous_inputs():
    """The CUDA path's first check, before anything asks for a device."""
    a = torch.randn(2, 3, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        pool._check_cuda([a, a.transpose(2, 3)])


@pytest.mark.parametrize("w,offset,want", [(128, 0, 1), (8, 0, 1), (12, 0, 0), (6, 0, 0),
                                           (16, 1, 0)])
def test_vector_path_needs_a_width_of_8_and_aligned_pointers(w, offset, want):
    t = torch.empty(64 * w + 8)[offset:offset + 64 * w].view(2, 2, 16, w)
    assert pool._vector(w, t) == want


# ---- the kernels on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _want(tensors, dtype):
    """The kernel's numbers: the plain version in f32, rounded once."""
    return pool2x2_add_plain(*(None if t is None else t.float() for t in tensors)).to(dtype)


def _check_site(device, variant, shape, dtype, seed=0):
    tensors = _inputs(variant, shape, dtype, device, seed)
    before = pool2x2_add.kernel_calls
    got = pool2x2_add(*tensors)
    torch.cuda.synchronize()
    assert pool2x2_add.kernel_calls == before + 1
    assert got.dtype == dtype and got.shape == (*shape[:2], shape[2] // 2, shape[3] // 2)
    assert _bits_equal(got, _want(tensors, dtype))
    if dtype == torch.float32:
        assert _bits_equal(got, pool2x2_add_plain(*tensors))
    return tensors, got


def _check_backward(tensors, got):
    """The backward: one launch, one tensor for a and b, equal to
    ``F.avg_pool2d``'s backward bit for bit; r's gradient the output gradient."""
    grad = torch.randn(got.shape, device=got.device).to(got.dtype)
    before = pool2x2_add.backward_calls
    _, got_g = _grads(pool2x2_add, tensors, grad)
    torch.cuda.synchronize()
    assert pool2x2_add.backward_calls == before + 1
    a = tensors[0].detach().requires_grad_(True)
    (want,) = torch.autograd.grad(F.avg_pool2d(a, 2), [a], grad)
    assert _bits_equal(got_g[0], want)
    rest = list(got_g[1:])
    if tensors[1] is not None:
        assert _bits_equal(rest.pop(0), want)
    if tensors[2] is not None:
        assert _bits_equal(rest.pop(0), grad)


# (name, a's shape, variant): each downsampling site of the benchmark's cells
# (COCO b=256: the trunk of d128_app, 8 slots of 256 layouts at block_obj5; VG:
# 31 slots of 128), of d64 (Ours-ED at b=16, 8 slots) and of d256 at b=32
SITES = [("coco.image", (256, 3, 128, 128), "a"), ("coco.block1", (256, 64, 128, 128), "ar"),
         ("coco.block2", (256, 128, 64, 64), "ab"), ("coco.block3", (256, 256, 32, 32), "ab"),
         ("coco.block4", (256, 512, 16, 16), "ab"), ("coco.block5", (256, 1024, 8, 8), "ab"),
         ("coco.block_obj5", (2048, 1024, 8, 8), "ab"), ("vg.block_obj5", (3968, 1024, 8, 8), "ab"),
         ("d64.block3", (16, 128, 32, 32), "ab"), ("d64.block4", (16, 256, 16, 16), "ab"),
         ("d64.block5", (16, 512, 8, 8), "ab"), ("d64.block_obj4", (128, 256, 8, 8), "ab"),
         ("d256.image", (32, 3, 256, 256), "a"), ("d256.block1", (32, 64, 256, 256), "ar"),
         ("d256.block2", (32, 64, 128, 128), "ab"), ("d256.block6", (32, 512, 8, 8), "ab"),
         ("d256.block_obj6", (256, 512, 8, 8), "ab")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,shape,variant", SITES, ids=[s[0] for s in SITES])
def test_kernel_at_every_d_site(cuda_device, name, shape, variant, dtype):
    _check_backward(*_check_site(cuda_device, variant, shape, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(3, 5, 8, 16), (2, 3, 6, 6), (2, 3, 4, 12), (1, 7, 10, 40)])
def test_kernel_variants_and_widths(cuda_device, shape, variant, dtype):
    """With and without b and r, on the vector path (widths 16, 40) and the
    scalar one (6, 12)."""
    _check_backward(*_check_site(cuda_device, variant, shape, dtype, seed=shape[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_unaligned_pointers(cuda_device, dtype):
    """Contiguous views whose data does not start on 16 bytes take the
    scalar path."""
    shape = (2, 4, 8, 16)
    n = 2 * 4 * 8 * 16

    def view(seed, count, s):
        t = torch.randn(count + 1, generator=torch.Generator().manual_seed(seed)).to(cuda_device,
                                                                                     dtype)
        return t[1:].view(s)

    tensors = (view(0, n, shape), view(1, n, shape), view(2, n // 4, (2, 4, 4, 8)))
    assert pool._vector(16, *tensors) == 0
    got = pool2x2_add(*tensors)
    assert _bits_equal(got, _want(tensors, dtype))
    _check_backward(tensors, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_are_bit_identical_run_to_run(cuda_device, dtype):
    tensors = _inputs("abr", (64, 256, 32, 32), dtype, cuda_device)
    grad = torch.randn(64, 256, 16, 16, device=cuda_device).to(dtype)
    runs = [_grads(pool2x2_add, tensors, grad) for _ in range(3)]
    for out, gs in runs[1:]:
        assert _bits_equal(out, runs[0][0])
        for g, g0 in zip(gs, runs[0][1]):
            assert _bits_equal(g, g0)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_on_the_card(cuda_device):
    a = torch.randn(2, 3, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="even"):
        pool2x2_add(torch.randn(2, 3, 8, 7, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        pool2x2_add(a.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        pool2x2_add(a, torch.randn(2, 3, 8, 8, device=cuda_device).transpose(2, 3))
    with pytest.raises(ValueError, match="different devices"):
        pool2x2_add(a, torch.randn(2, 3, 8, 8))
    with pytest.raises(ValueError, match="different devices"):
        pool2x2_add(a, r=torch.randn(2, 3, 4, 4))
    with pytest.raises(TypeError, match="one dtype"):
        pool2x2_add(a.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_pool_operators_pass_opcheck(cuda_device, variant, dtype):
    """Both operators: schema, fake implementations, the autograd
    registration and AOT dispatch (``torch.library.opcheck``)."""
    ops = torch.ops.layout2img_tpu_torch
    a, b, r = _inputs(variant, (2, 4, 8, 16), dtype, cuda_device)
    torch.library.opcheck(ops.pool2x2_add_backward.default,
                          (torch.randn(2, 4, 4, 8, device=cuda_device).to(dtype),))
    for t in (a, b, r):
        if t is not None:
            t.requires_grad_(True)
    torch.library.opcheck(ops.pool2x2_add.default, (a, b, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_a_row_shard_is_the_rows_of_the_whole(cuda_device, dtype):
    """The 2-D mesh's spatial mode pools each rank's rows (an even count):
    a shard's output and gradients are the matching rows of the whole call."""
    a, b, r = _inputs("abr", (4, 64, 32, 32), dtype, cuda_device)
    grad = torch.randn(4, 64, 16, 16, device=cuda_device).to(dtype)
    whole, whole_g = _grads(pool2x2_add, (a, b, r), grad)
    for r0, rows in ((0, 16), (16, 16), (8, 8)):
        part = (a[:, :, r0:r0 + rows].contiguous(), b[:, :, r0:r0 + rows].contiguous(),
                r[:, :, r0 // 2:(r0 + rows) // 2].contiguous())
        got, got_g = _grads(pool2x2_add, part, grad[:, :, r0 // 2:(r0 + rows) // 2].contiguous())
        assert _bits_equal(got, whole[:, :, r0 // 2:(r0 + rows) // 2])
        for g, w, half in zip(got_g, whole_g, (False, False, True)):
            lo, hi = (r0 // 2, (r0 + rows) // 2) if half else (r0, r0 + rows)
            assert _bits_equal(g, w[:, :, lo:hi])


def _d_inputs(device, b=4, o=8, size=128):
    gen = torch.Generator().manual_seed(2)
    images = (torch.rand(b, 3, size, size, generator=gen) * 2 - 1).to(device)
    boxes = (torch.rand(b, o, 4, generator=gen) * 0.5 + 0.1).to(device)
    labels = torch.randint(1, 184, (b, o), generator=gen)
    labels[:, o // 2:] = 0
    return images, boxes, labels.to(device)


def _d_step(disc, images, boxes, labels):
    """D's outputs and the gradients of its summed scores (images and
    parameters)."""
    leaf = images.clone().requires_grad_(True)
    out = disc(leaf, boxes, labels)
    loss = sum(v.float().sum() for k, v in out.items() if k != "valid")
    params = [p for p in disc.parameters() if p.requires_grad]
    return [out[k] for k in sorted(out)], torch.autograd.grad(loss, [leaf, *params])


@pytest.mark.cuda
def test_d_launches_the_kernel_at_every_site_and_no_avg_pool2d(cuda_device):
    """A ``d128_app`` forward launches the forward kernel ``pool_sites`` (7)
    times and its backward the backward kernel 7 times; the profile of both
    holds those launches and no PyTorch ``avg_pool2d`` kernel."""
    from torch.profiler import ProfilerActivity, profile

    disc = init_discriminator(0, 184, "d128_app", device=cuda_device, ch=32).train()
    assert disc.pool_sites == 7
    inputs = _d_inputs(cuda_device)
    _d_step(disc, *inputs)  # warm-up
    torch.cuda.synchronize()
    before = (pool2x2_add.kernel_calls, pool2x2_add.backward_calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _d_step(disc, *inputs)
        torch.cuda.synchronize()
    assert (pool2x2_add.kernel_calls - before[0], pool2x2_add.backward_calls - before[1]) == (7, 7)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("pool2x2_forward_kernel" in n for n in names) == 7
    assert sum("pool2x2_backward_kernel" in n for n in names) == 7
    assert not [n for n in names if "avg_pool2d" in n]


@pytest.mark.cuda
def test_d_with_remat_blocks_equals_d_without(cuda_device):
    """``remat_blocks=3`` recomputes the first three trunk blocks in the
    backward: the same outputs and gradients (cuDNN in its deterministic
    algorithms). The pool saves nothing for its backward, so the recompute
    (non-reentrant checkpoint, which stops after the last saved tensor it
    needs) runs only block1's image pool again, whose output the shortcut
    conv saves: 8 forward launches and 7 backward ones."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for blocks in (0, 3):
            disc = init_discriminator(0, 184, "d128_app", device=cuda_device, ch=32,
                                      remat_blocks=blocks).train()
            before = (pool2x2_add.kernel_calls, pool2x2_add.backward_calls)
            runs.append(_d_step(disc, *_d_inputs(cuda_device)))
            torch.cuda.synchronize()
            calls = (pool2x2_add.kernel_calls - before[0], pool2x2_add.backward_calls - before[1])
            assert calls == ((8, 7) if blocks else (7, 7))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (outs, grads), (outs_r, grads_r) = runs
    for x, y in zip(outs + list(grads), outs_r + list(grads_r)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6 * max(y.abs().max().item(), 1e-30))
