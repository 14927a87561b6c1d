"""The port's hand-written GPU kernels against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

Bars: f32 at 1e-5 * max|plain| (the kernel and the plain version differ in
summation order and in folding 1/d into the mask); bf16 at 1e-2 * max|plain|
(the plain version rounds the BN output and the resized mask to bf16, the
kernel keeps both in f32).
"""

import pytest
import torch

from layout2img_tpu_torch.ops import _build
from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_plain

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


@pytest.mark.cuda
def test_isla_kernel_refuses_autograd(cuda_device):
    """No backward kernel yet: a forward that autograd would record raises
    instead of returning a result cut off from the graph."""
    x, mean, var, eps, mask, gamma, beta = _inputs(0, 2, 8, 32, (8, 8), (8, 8), torch.float32,
                                                   cuda_device)
    gamma.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        isla_norm(x, mean, var, eps, mask, gamma, beta)
    with torch.no_grad():
        isla_norm(x, mean, var, eps, mask, gamma, beta)
    with torch.inference_mode():
        isla_norm(x, mean, var, eps, mask, gamma, beta)


@pytest.mark.cuda
def test_build_all_builds_every_source(cuda_device):
    seconds = _build.build_all()
    assert set(seconds) == set(_build.sources()) and "isla_norm" in seconds
    for name in seconds:
        assert _build.library_path(name).exists()
