"""Reference (original torch) weights into the port: LostGAN generator and
discriminator ``.pth`` state dicts, torchvision VGG19 features, and the
fine-tuning entry of ``cli/train.py`` (counterpart of the JAX package's
``utils/torch_import.py`` with ``train/state.py::load_torch_into_state`` and
``losses/perceptual.py::load_torch_vgg19_features``).

The port's modules carry the reference's names, so a reference dict loads
with ``strict=True`` once the ``module.`` (DataParallel) and ``obD.``
(``CombineDiscriminator``) prefixes are stripped. A generator that runs
reference weights is built with ``legacy_attention=True``: the reference's
checkpoints were trained with its attention-concat scramble
(``nn/attention.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from layout2img_tpu_torch.losses.perceptual import VGG19Features
from layout2img_tpu_torch.train.ema import ema_init
from layout2img_tpu_torch.train.state import GANTrainState


def reference_state_dict(sd_or_path) -> dict[str, torch.Tensor]:
    """A reference state dict (or the path of its ``.pth``) with the
    ``module.`` and ``obD.`` prefixes stripped, on the CPU."""
    sd = sd_or_path
    if not isinstance(sd, dict):
        sd = torch.load(sd_or_path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module.").removeprefix("obD."): v for k, v in sd.items()}


def load_strict(module: nn.Module, sd: dict, name: str) -> None:
    """``load_state_dict(strict=True)``, raising ``ValueError`` that names
    what to check when the dict does not fit the constructed network."""
    try:
        module.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise ValueError(f"torch checkpoint does not fit the constructed {name} (check --model / "
                         f"dataset num_classes / --img_size / --ch): {e}") from e


def load_torch_vgg19_features(path: str, device: str | torch.device = "cpu") -> VGG19Features:
    """A torchvision ``vgg19`` state dict (``.pth``) in ``VGG19Features``:
    either the whole model's (``features.N.*``, the classifier ignored) or
    the bare features' (``N.*``); layers past relu5_1 are ignored."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    vgg = VGG19Features()
    want = vgg.state_dict()
    got = {}
    for k, v in sd.items():
        name = k if k.startswith("features.") else f"features.{k}"
        if name in want:
            got[name] = v
    load_strict(vgg, got, "VGG19 features")
    return vgg.to(device)


def load_torch_into_state(state: GANTrainState, g_sd: dict | None = None,
                          d_sd: dict | None = None) -> GANTrainState:
    """Load reference G and/or D state dicts into the state's networks, in
    place; the loaded network's Adam moments restart at zero, and the EMA
    restarts from the loaded generator. A dict that does not fit the
    network raises ``ValueError``."""
    if g_sd is not None:
        load_strict(state.generator, reference_state_dict(g_sd), "generator")
        state.g_opt.state.clear()
        if state.ema is not None:
            state.ema = ema_init(state.generator)
    if d_sd is not None:
        load_strict(state.discriminator, reference_state_dict(d_sd), "discriminator")
        state.d_opt.state.clear()
    return state
