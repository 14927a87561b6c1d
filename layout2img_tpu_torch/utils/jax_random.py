"""JAX's default PRNG and the flax initializers the JAX package uses, in numpy.

The port does not import JAX, yet one check needs the JAX package's own
initial weights: the conditioning check starts, as the JAX script does, from
``create_train_state(jax.random.PRNGKey(0), ...)``
(``scripts/train_conditioning_check.py``; ``layout2img_tpu_torch/scripts/
conditioning_init.json`` records which key each leaf was drawn from). This
module redraws them: threefry-2x32 in JAX's partitionable mode (JAX's
default since 0.5), ``split``, ``fold_in``, flax's SHA-1 fold of a scope's
path into its ``params`` key, the uniform and normal draws (XLA's
single-precision ``erf_inv``), and the orthogonal, variance-scaling, zero,
one and the GCN's uniform initializers. Bits are JAX's; floats agree with it to f32 round-off
(numpy's ``log`` and ``erf`` and torch's LAPACK QR against XLA's).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 block function (20 rounds) of ``key`` (2,) uint32 on
    the count pairs (x0, x1), as ``jax._src.prng`` computes it."""
    with np.errstate(over="ignore"):
        k0, k1 = _U32(key[0]), _U32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    return np.array([0, seed], _U32)


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32."""
    return np.stack(threefry2x32(key, *_iota_2x32((num,))), axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    out = threefry2x32(key, np.array([0], _U32), np.array([data], _U32))
    return np.array([out[0][0], out[1][0]], _U32)


def fold_in_path(key: np.ndarray, path: tuple) -> np.ndarray:
    """flax's ``_fold_in_static``: the SHA-1 of a scope's path (strings and
    ints, e.g. the module names and the scope's ``make_rng`` count) folded
    into ``key``."""
    if not path:
        return key
    h = hashlib.sha1()
    for x in path:
        h.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(h.digest()[:4], byteorder="big"))


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element (``jax.random.bits``)."""
    b0, b1 = threefry2x32(key, *_iota_2x32(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32: 23 random mantissa bits, scaled."""
    f32 = np.float32
    bits = (random_bits(key, tuple(shape)) >> _U32(9)) | np.array(1.0, f32).view(_U32)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, (bits.view(f32) - f32(1.0)) * (hi - lo) + lo)


_ERF_INV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GT = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision inverse error function (Giles' polynomials)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(np.maximum(w, f32(0.0))) - f32(3.0)).astype(f32)
    p_lt, p_gt = f32(_ERF_INV_LT[0]), f32(_ERF_INV_GT[0])
    for a, b in zip(_ERF_INV_LT[1:], _ERF_INV_GT[1:]):
        p_lt = f32(a) + p_lt * w
        p_gt = f32(b) + p_gt * w
    out = np.where(lt, p_lt, p_gt) * x
    return np.where(np.abs(x) == f32(1.0), np.copysign(f32(np.inf), x), out).astype(f32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in f32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * erf_inv(uniform(key, shape, lo, 1.0))


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal`` in f32."""
    f32 = np.float32
    sqrt2 = f32(np.sqrt(2))
    a, b = (f32(math.erf(float(f32(v) / sqrt2))) for v in (lower, upper))
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(f32(lower), f32(np.inf)), np.nextafter(f32(upper), -f32(np.inf)))


def orthogonal(key: np.ndarray, shape, column_axis: int = -1) -> np.ndarray:
    """flax's ``initializers.orthogonal()`` (``jax.nn.initializers.orthogonal``)."""
    shape = tuple(shape)
    n_cols = shape[column_axis]
    n_rows = math.prod(shape) // n_cols
    a = normal(key, (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols))
    q, r = (t.numpy() for t in torch.linalg.qr(torch.from_numpy(a)))  # LAPACK, threaded
    q = q * np.sign(np.diag(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    q = q.reshape(tuple(np.delete(shape, column_axis)) + (n_cols,))
    return np.moveaxis(q, -1, column_axis).astype(np.float32)


def _fans(shape, in_axis: int = -2, out_axis: int = -1) -> tuple[float, float]:
    receptive = math.prod(shape) / (shape[in_axis] * shape[out_axis])
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def variance_scaling(key: np.ndarray, shape, scale: float, mode: str, distribution: str,
                     in_axis: int = -2, out_axis: int = -1) -> np.ndarray:
    """``jax.nn.initializers.variance_scaling`` in f32."""
    fan_in, fan_out = _fans(tuple(shape), in_axis, out_axis)
    denominator = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = np.float32(scale / denominator)
    if distribution == "truncated_normal":
        stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
        return (truncated_normal(key, -2, 2, shape) * stddev).astype(np.float32)
    if distribution == "normal":
        return (normal(key, shape) * np.sqrt(variance)).astype(np.float32)
    return (uniform(key, shape, -1, 1) * np.sqrt(3 * variance)).astype(np.float32)


def initializer(kind: str, key: np.ndarray, shape) -> np.ndarray:
    """One of the initializers the JAX package's modules use, by name."""
    shape = tuple(shape)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    if kind == "normal":
        return normal(key, shape)
    if kind == "orthogonal":
        return orthogonal(key, shape)
    if kind == "uniform_fan_out":  # the GCN's U(-1, 1) / sqrt(out) (reference GraphConvolution)
        return uniform(key, shape, -1, 1) / np.sqrt(np.float32(shape[-1]))
    kinds = {"lecun_normal": (1.0, "fan_in", "truncated_normal"),
             "xavier_uniform": (1.0, "fan_avg", "uniform"),
             "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
             "he_normal": (2.0, "fan_in", "truncated_normal")}
    if kind not in kinds:
        raise ValueError(f"unknown initializer {kind!r}")
    return variance_scaling(key, shape, *kinds[kind])
