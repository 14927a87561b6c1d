"""Seeded weights, drawn on the device in one call.

The state dict of a reference network gives the names and shapes; the
program's networks use the same names, so the one dict loads into both.
Every random leaf is a slice of one standard normal draw from a
``torch.Generator`` on the device: weights scaled by 1/sqrt(fan_in) (LeCun),
spectral-norm vectors u unit, v = normalize(W^T u) after two power
iterations, so the stored sigma estimate starts near the true one. Biases,
BN shifts and the stage-mask alphas are zero; BN and LayerNorm scales one;
running statistics the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _kind(name: str, shape: tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight_orig", "weight_u") or (leaf == "weight" and len(shape) >= 2):
        return "normal"
    if leaf == "weight_v":
        return "derived"
    if leaf in ("weight", "running_var"):
        return "one"
    return "zero"  # biases, running means, counters, alphas


def draw(spec: dict[str, torch.Tensor], seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """A state dict with ``spec``'s names, shapes and dtypes on ``device``,
    drawn from ``seed``."""
    normal = [(k, tuple(t.shape)) for k, t in spec.items() if _kind(k, tuple(t.shape)) == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in normal:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if k.endswith("weight_u"):
            out[k] = F.normalize(t, dim=0)
        else:
            out[k] = t.mul_(1.0 / math.sqrt(max(1, n // shape[0])))
    for k, t in spec.items():
        kind = _kind(k, tuple(t.shape))
        if kind == "one":
            out[k] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif kind == "zero":
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    with torch.no_grad():
        for k in spec:
            if k.endswith("weight_v"):
                base = k[: -len("weight_v")]
                w = out[base + "weight_orig"].reshape(out[base + "weight_orig"].shape[0], -1)
                u = out[base + "weight_u"]
                for _ in range(2):
                    v = F.normalize(w.T @ u, dim=0)
                    u = F.normalize(w @ v, dim=0)
                out[base + "weight_u"] = u
                out[k] = F.normalize(w.T @ u, dim=0)
    return {k: out[k] for k in spec}
