"""The one traffic generator: every input of a run, drawn from ``--seed``
on the device by the parameters of a traffic file and a configuration.

- layouts: n ~ U[objects] real objects per layout at the front of ``slots``
  slots, classes uniform over 1..num_classes-1, boxes xywh with sides
  U[box_side] and corners inside the image; the rest pad slots (class 0,
  the loaders' pad box);
- images (train mixes): uniform noise in [-1, 1], f32, as the loaders give;
- per-unit seeds: the step's latent generator and the dropout generator are
  reseeded before every step or batch, so a unit's inputs depend on the
  seed and its index only.
"""

from __future__ import annotations

import torch

PAD_BOX = (-0.6, -0.6, 0.5, 0.5)  # the data loaders' box for an empty slot
_M64 = (1 << 64) - 1


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of ``seed`` (splitmix64's finalizer)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


# streams of one run's seed
WEIGHTS_G, WEIGHTS_D, WEIGHTS_VGG, POOL = 1, 2, 3, 4
LATENTS, DROPOUT = 1 << 20, 2 << 20  # + the unit's index


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def pool(seed: int, config: dict, traffic: dict, device: torch.device,
         images: bool) -> list[dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches of ``config["batch"]`` layouts (and
    images), each a dict of ``boxes`` (b, o, 4) f32, ``labels`` (b, o)
    int64 and, with ``images``, ``images`` (b, 3, s, s) f32."""
    g = generator(seed, POOL, device)
    n, b, o = int(traffic["pool"]), int(config["batch"]), int(config["slots"])
    lo, hi = config["objects"]
    s_lo, s_hi = traffic["box_side"]
    count = torch.randint(int(lo), int(hi) + 1, (n, b, 1), generator=g, device=device)
    real = torch.arange(o, device=device) < count
    labels = torch.randint(1, int(config["num_classes"]), (n, b, o), generator=g,
                           device=device) * real
    side = s_lo + (s_hi - s_lo) * torch.rand((n, b, o, 2), generator=g, device=device)
    corner = torch.rand((n, b, o, 2), generator=g, device=device) * (1.0 - side)
    boxes = torch.where(real[..., None], torch.cat([corner, side], dim=-1),
                        torch.tensor(PAD_BOX, device=device))
    out = [{"boxes": boxes[i].contiguous(), "labels": labels[i].contiguous()} for i in range(n)]
    if images:
        size = int(config["image_size"])
        for batch in out:
            batch["images"] = torch.rand((b, 3, size, size), generator=g, device=device) * 2 - 1
    return out


def seed_unit(seed: int, k: int, rng: torch.Generator, device: torch.device) -> None:
    """Reseed ``rng`` (the step's or sampler's latents) and the device's
    default generator (dropout) for unit ``k``."""
    rng.manual_seed(mix(seed, LATENTS + k))
    if device.type == "cuda":
        torch.cuda.manual_seed(mix(seed, DROPOUT + k))
    else:
        torch.manual_seed(mix(seed, DROPOUT + k))
