"""GAN training state (counterpart of ``layout2img_tpu/train/state.py``).

``TrainConfig`` keeps the JAX package's field names, defaults and meanings
(its comments there say what each knob does; ``train/step.py`` here how the
port does it). The state holds the two networks, one
``torch.optim.Adam(lr, betas=(beta1, beta2), eps=1e-8)`` each (optax's
``adam`` defaults) and, when ``ema_decay > 0``, the generator's EMA
(``train/ema.py``). ``mapping_lr_mult`` applies only to parameters named
``mapping``, which no ported network has: a network with one raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from layout2img_tpu_torch.train.ema import ema_init

_ROADMAP_MAPPING = ("ROADMAP.md §1 'Slices still to port', item 1 (mapping_lr_mult: no LostGAN "
                    "network has a mapping)")
REMAT_MODES = ("none", "g", "d", "gd")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    z_dim: int = 128
    g_lr: float = 1e-4
    d_lr: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.999
    lamb_obj: float = 1.0
    lamb_app: float = 1.0
    lamb_img: float = 0.1
    use_pixel_loss: bool = True
    use_vgg_loss: bool = True
    mapping_lr_mult: float = 0.1
    fused_d: bool = False
    ema_decay: float = 0.0
    mixed_precision: bool = False
    remat: str = "none"
    d_obj_budget: int = 0
    g_obj_budget: int = 0

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"TrainConfig.remat {self.remat!r} is not one of {REMAT_MODES}")


@dataclasses.dataclass
class GANTrainState:
    """Both networks, their optimizers, the step count and the generator's
    EMA (``{name: f32 tensor}``, or None without ``ema_decay``). The step
    updates all of it in place."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None


def _adam(module: nn.Module, lr: float, cfg: TrainConfig) -> torch.optim.Adam:
    if any("mapping" in name for name, _ in module.named_parameters()):
        raise NotImplementedError(f"mapping_lr_mult is not ported yet: {_ROADMAP_MAPPING}")
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       config: TrainConfig) -> GANTrainState:
    """Wrap initialized networks (``utils.convert.init_generator`` and
    ``init_discriminator``, or loaded state dicts) with fresh optimizers, and
    start the EMA from a copy of G's parameters when ``ema_decay > 0``."""
    return GANTrainState(generator, discriminator, _adam(generator, config.g_lr, config),
                         _adam(discriminator, config.d_lr, config),
                         ema=ema_init(generator) if config.ema_decay > 0 else None)
