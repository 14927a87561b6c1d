"""Training CLI (counterpart of ``layout2img_tpu/cli/train.py``), minimal: any
LostGAN-family experiment (``--model``, default ``context_app_v2``: the
Ours-D 128px generator ``ours_d_context128`` against ``d128_app``; the map
is ``cli/presets.py``) at its own image size, on synthetic batches (184
classes, 8 object slots, as the JAX CLI's ``--dataset synthetic``), from
seeded random weights. Each step's metrics go to standard output and to
``<out_path>/metrics.jsonl`` as one JSON line; at the end ``G.pth`` and
``D.pth`` (reference-format state dicts, which ``cli.sample --model ...
--weights`` loads) go to ``out_path``, and with ``--ema_decay`` also
``G_ema.pth``: the EMA parameters with the live generator's buffers, the
pair the JAX package samples with.

    python -m layout2img_tpu_torch.cli.train --model context_app_v2 --dataset synthetic \\
        --steps 5 --batch_size 8 --out_path out [--mixed_precision] [--ema_decay 0.999] \\
        [--fused_d] [--remat g|d|gd] [--remat_d_blocks N] \\
        [--g_obj_budget K] [--d_obj_budget K] [--obj_budget_force]

The step's knobs are the JAX CLI's flags, with its meanings
(``train/step.py``). Without ``--mixed_precision`` the step runs in f32, as
the JAX package's default ``TrainConfig`` does: TF32 is switched off in
cuDNN and in matmul. ``--g_obj_budget`` is refused for a generator on which
compaction is not exact (the v1 mask trunk, ``models/generators.py::
obj_budget_error``), and the object budgets are checked against the
dataset's valid-object counts (``check_obj_budgets``). The special families
(``ours_ed``, ``layout2im``) raise ``NotImplementedError``.

Runs on the GPU; ``--device cpu`` asks for the CPU. The JAX CLI's other
flags (COCO and VG data, checkpoints and resume, eval hooks) wait for the
ROADMAP.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from layout2img_tpu_torch.cli.presets import dataset_spec, experiment
from layout2img_tpu_torch.data.synthetic import synthetic_batch, synthetic_valid_object_counts
from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.losses.perceptual import VGGLoss
from layout2img_tpu_torch.models.generators import obj_budget_error
from layout2img_tpu_torch.train.state import REMAT_MODES, TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

SYNTHETIC_CLASSES, SYNTHETIC_OBJECTS = dataset_spec("synthetic")
logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="context_app_v2",
                   help="experiment preset (cli/presets.py): G, D and image size")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"],
                   help="COCO and VG loaders are not ported yet")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--ch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_vgg", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute over f32 master weights")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="generator EMA decay (e.g. 0.999); 0 disables. Also writes G_ema.pth")
    p.add_argument("--fused_d", action="store_true",
                   help="one 2b-batch D call for real+fake (score-identical)")
    p.add_argument("--remat", default="none", choices=list(REMAT_MODES),
                   help="recompute the G forward / D calls in the backward (same math)")
    p.add_argument("--remat_d_blocks", type=int, default=0,
                   help="recompute only the first N D trunk blocks (the large activations)")
    p.add_argument("--d_obj_budget", type=int, default=0,
                   help="give D only the first K valid-compacted object slots (0 = all); "
                        "exact when K >= the most objects of a layout")
    p.add_argument("--g_obj_budget", type=int, default=0,
                   help="run the generator (and D) on the first K valid-compacted object "
                        "slots (0 = all); objects beyond K drop out of the generated image")
    p.add_argument("--obj_budget_force", action="store_true",
                   help="accept a --g_obj_budget below the dataset's most valid objects")
    p.add_argument("--out_path", default="./outputs/tmp")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def check_obj_budgets(counts: np.ndarray | None, args, log: logging.Logger = logger) -> None:
    """The object-budget guard (``layout2img_tpu/cli/train.py::check_obj_budgets``).

    The budgets are exact only when K covers every layout's valid objects;
    the reference's ragged ``label != 0`` path never drops one. From the
    dataset's valid-object counts (None: no index, so unchecked): log their
    distribution, refuse a ``--g_obj_budget`` below the most (overflow
    objects would vanish from the generated images) unless
    ``--obj_budget_force``, and warn for a ``--d_obj_budget`` below it
    (overflow objects drop from D's view only)."""
    if not (args.g_obj_budget or args.d_obj_budget):
        return
    if counts is None:
        log.warning("the dataset has no valid-object-count index; object budgets are UNCHECKED")
        return
    c = np.asarray(counts)
    if c.size == 0:
        return
    mx = int(c.max())
    log.info("valid objects per image: max %d, p50 %d, p95 %d, p99 %d (%d layouts)", mx,
             int(np.percentile(c, 50)), int(np.percentile(c, 95)), int(np.percentile(c, 99)),
             c.size)
    for name, k, fatal in (("--g_obj_budget", args.g_obj_budget, True),
                           ("--d_obj_budget", args.d_obj_budget, False)):
        if not k or k >= mx:
            continue
        over = float((c > k).mean()) * 100.0
        msg = (f"{name} {k} is below the dataset's max valid object count {mx}: {over:.2f}% of "
               "layouts exceed it and lose their overflow objects "
               + ("from the GENERATED IMAGE" if fatal else "from D's view only")
               + f"; {name} {mx} is exact")
        if fatal and not args.obj_budget_force:
            raise SystemExit(msg + " (pass --obj_budget_force to accept the drop)")
        log.warning(msg + (" (accepted via --obj_budget_force)" if fatal else ""))


def ema_state_dict(gen: torch.nn.Module, ema: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The generator's state dict with the EMA in place of its parameters."""
    return {k: ema.get(k, v) for k, v in gen.state_dict().items()}


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    device = resolve_device(args.device)
    exp = experiment(args.model)
    check_obj_budgets(synthetic_valid_object_counts(SYNTHETIC_OBJECTS), args)
    gen = init_generator(args.seed, SYNTHETIC_CLASSES, preset=exp.gen_preset, device=device,
                         ch=args.ch)
    if args.g_obj_budget:
        why = obj_budget_error(gen)
        if why is not None:
            raise SystemExit(f"--g_obj_budget is not exact for this model: {why}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    config = TrainConfig(mixed_precision=args.mixed_precision, ema_decay=args.ema_decay,
                         fused_d=args.fused_d, remat=args.remat, d_obj_budget=args.d_obj_budget,
                         g_obj_budget=args.g_obj_budget)
    disc = init_discriminator(args.seed + 1, SYNTHETIC_CLASSES, preset=exp.disc_preset,
                              device=device, ch=args.ch, remat_blocks=args.remat_d_blocks)
    vgg = None if args.no_vgg else VGGLoss(init_vgg(args.seed + 2, device=device))
    state = create_train_state(gen, disc, config)
    step = make_train_step(state, config, vgg_loss=vgg)

    os.makedirs(args.out_path, exist_ok=True)
    data_rng = np.random.default_rng(args.seed)
    z_rng = torch.Generator(device=device).manual_seed(args.seed)
    with open(os.path.join(args.out_path, "metrics.jsonl"), "w") as log:
        for i in range(args.steps):
            t0 = time.perf_counter()
            batch = synthetic_batch(data_rng, args.batch_size, exp.image_size,
                                    SYNTHETIC_OBJECTS, SYNTHETIC_CLASSES)
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            batch["labels"] = batch["labels"].long()
            metrics = {k: float(v) for k, v in step(batch, z_rng).items()}
            line = json.dumps({"step": state.step, "seconds": time.perf_counter() - t0, **metrics})
            print(line, flush=True)
            log.write(line + "\n")
    written = {"G.pth": gen.state_dict(), "D.pth": disc.state_dict()}
    if state.ema is not None:
        written["G_ema.pth"] = ema_state_dict(gen, state.ema)
    for name, sd in written.items():
        torch.save(sd, os.path.join(args.out_path, name))
    print(f"wrote {', '.join(written)} after {state.step} steps to {args.out_path}")


if __name__ == "__main__":
    main()
