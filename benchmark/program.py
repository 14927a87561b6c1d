"""The system under test, reached through its normal entries only:
``models.generators.make_generator``, ``models.discriminators.make_discriminator``,
``losses.perceptual``, ``train.state.create_train_state`` and
``train.step.make_train_step`` (as ``cli/train.py`` builds them, with
``parallel.mesh.initialize`` and ``replicate`` for data-parallel ranks), and
``sample.make_sample_fn`` with ``utils.casting.cast_floating`` (as
``cli/sample.py --bf16`` serves). The program is imported here and nowhere
else in the harness.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _networks(config: dict, weights: dict, device: torch.device, train: bool):
    """(G, D, VGG19's features) holding ``weights``; only G to sample, no
    features without the configuration's VGG loss."""
    from layout2img_tpu_torch.losses.perceptual import VGG19Features
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator

    gen = make_generator(config["generator"], config["num_classes"], device=device, ch=config["ch"])
    gen.load_state_dict(weights["G"])
    if not train:
        return gen, None, None
    disc = make_discriminator(config["discriminator"], config["num_classes"], device=device,
                              ch=config["ch"])
    disc.load_state_dict(weights["D"])
    if not config.get("vgg"):
        return gen, disc, None
    with torch.device("meta"):
        features = VGG19Features()
    features = features.to_empty(device=device)
    features.load_state_dict(weights["VGG"])
    return gen, disc, features


def build_train(config: dict, weights: dict, device: torch.device) -> SimpleNamespace:
    """The train step of ``config`` on networks holding ``weights``
    (``{"G", "D", "VGG"}`` state dicts): ``step(batch, rng) -> metrics``,
    the state, and readers of what the check compares."""
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.parallel.mesh import current, replicate
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step

    gen, disc, features = _networks(config, weights, device, train=True)
    cfg = TrainConfig(z_dim=config["z_dim"], **config["train_config"])
    state = create_train_state(gen, disc, cfg)
    replicate(current(), state)  # rank 0's state on every rank; one process: nothing
    step = make_train_step(state, cfg, vgg_loss=VGGLoss(features) if features is not None else None)
    nets = {"G": (gen, state.g_opt), "D": (disc, state.d_opt)}

    def params() -> dict[str, torch.Tensor]:
        return {f"{k}.{n}": p for k, (net, _) in nets.items() for n, p in net.named_parameters()}

    def grad_sq_sums() -> dict[str, torch.Tensor]:
        """Per parameter, the sum of Adam's second moment (after one step:
        (1 - beta2) |g|^2 of the gradient the optimizer got)."""
        return {f"{k}.{n}": opt.state[p]["exp_avg_sq"].sum()
                for k, (net, opt) in nets.items() for n, p in net.named_parameters()}

    return SimpleNamespace(step=step, state=state, params=params, grad_sq_sums=grad_sq_sums,
                           beta2=cfg.beta2)


def build_sampler(config: dict, weights: dict, device: torch.device) -> SimpleNamespace:
    """``sample(boxes, labels, rng) -> images`` of the served generator:
    weights cast to the configuration's precision, eval mode."""
    from layout2img_tpu_torch.sample import make_sample_fn
    from layout2img_tpu_torch.utils.casting import cast_floating

    dtype = DTYPES[config["precision"]]
    gen, _, _ = _networks(config, weights, device, train=False)
    cast_floating(gen.eval(), dtype)
    return SimpleNamespace(sample=make_sample_fn(gen, z_dim=config["z_dim"],
                                                 truncation=config["truncation"], dtype=dtype),
                           generator=gen)


def init_ranks(device: torch.device, timeout_s: float) -> None:
    """Join this process to the data-parallel run that ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` describe, and make
    its mesh the current one (NCCL on CUDA, gloo on the CPU)."""
    from layout2img_tpu_torch.parallel.mesh import initialize

    initialize(device, timeout_s=timeout_s)


def shutdown_ranks() -> None:
    from layout2img_tpu_torch.parallel.mesh import shutdown

    shutdown()
