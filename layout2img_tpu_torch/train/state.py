"""GAN training state (counterpart of ``layout2img_tpu/train/state.py``).

``TrainConfig`` keeps the JAX package's field names and defaults. The knobs
whose code paths are not ported yet (``fused_d``, ``remat``,
``mixed_precision``, ``ema_decay`` and the two object budgets) raise
``NotImplementedError`` naming the ROADMAP when set. The state holds the two
networks and one ``torch.optim.Adam(lr, betas=(beta1, beta2), eps=1e-8)``
each, optax's ``adam`` defaults. ``mapping_lr_mult`` applies only to
parameters named ``mapping``, which the ported networks do not have.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

_ROADMAP_STEP = "ROADMAP.md §1 'Slices still to port', item 1 (the rest of the train step)"


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
        unported = {"fused_d": self.fused_d, "ema_decay": self.ema_decay > 0,
                    "mixed_precision": self.mixed_precision, "remat": self.remat != "none",
                    "d_obj_budget": self.d_obj_budget > 0, "g_obj_budget": self.g_obj_budget > 0}
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(f"TrainConfig.{name} is not ported yet: {_ROADMAP_STEP}")


@dataclasses.dataclass
class GANTrainState:
    """Both networks, their optimizers and the step count. The step updates
    all of it in place."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def _adam(module: nn.Module, lr: float, cfg: TrainConfig) -> torch.optim.Adam:
    if any("mapping" in name for name, _ in module.named_parameters()):
        raise NotImplementedError(f"mapping_lr_mult is not ported yet: {_ROADMAP_STEP}")
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       config: TrainConfig) -> GANTrainState:
    """Wrap initialized networks (``utils.convert.init_generator`` and
    ``init_discriminator``, or loaded state dicts) with fresh optimizers."""
    return GANTrainState(generator, discriminator, _adam(generator, config.g_lr, config),
                         _adam(discriminator, config.d_lr, config))
