"""Training CLI (counterpart of ``layout2img_tpu/cli/train.py``), minimal: the
Ours-D 128px generator (``ours_d_context128``) against ``d128_app`` on
synthetic batches (184 classes, 8 object slots, as the JAX CLI's
``--dataset synthetic``), from seeded random weights, with the default
``TrainConfig``. Each step's metrics go to standard output and to
``<out_path>/metrics.jsonl`` as one JSON line; at the end ``G.pth`` and
``D.pth`` (reference-format state dicts, which ``cli.sample --weights``
loads) go to ``out_path``.

    python -m layout2img_tpu_torch.cli.train --dataset synthetic --steps 5 \\
        --batch_size 8 --out_path out

Runs on the GPU; ``--device cpu`` asks for the CPU. The step runs in f32,
as the JAX package's default ``TrainConfig`` does: TF32 is switched off in
cuDNN and in matmul. The JAX CLI's other
flags (COCO and VG data, checkpoints and resume, EMA, mixed precision,
eval hooks) wait for the ROADMAP.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from layout2img_tpu_torch.data.synthetic import synthetic_batch
from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.losses.perceptual import VGGLoss
from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
from layout2img_tpu_torch.train.step import make_train_step
from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

SYNTHETIC_CLASSES, SYNTHETIC_OBJECTS = 184, 8  # the JAX CLI's synthetic spec
IMAGE_SIZE = 128


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"],
                   help="COCO and VG loaders are not ported yet")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--ch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_vgg", action="store_true")
    p.add_argument("--out_path", default="./outputs/tmp")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = init_generator(args.seed, SYNTHETIC_CLASSES, device=device, ch=args.ch)
    disc = init_discriminator(args.seed + 1, SYNTHETIC_CLASSES, device=device, ch=args.ch)
    vgg = None if args.no_vgg else VGGLoss(init_vgg(args.seed + 2, device=device))
    state = create_train_state(gen, disc, TrainConfig())
    step = make_train_step(state, TrainConfig(), vgg_loss=vgg)

    os.makedirs(args.out_path, exist_ok=True)
    data_rng = np.random.default_rng(args.seed)
    z_rng = torch.Generator(device=device).manual_seed(args.seed)
    with open(os.path.join(args.out_path, "metrics.jsonl"), "w") as log:
        for i in range(args.steps):
            t0 = time.perf_counter()
            batch = synthetic_batch(data_rng, args.batch_size, IMAGE_SIZE, SYNTHETIC_OBJECTS,
                                    SYNTHETIC_CLASSES)
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            batch["labels"] = batch["labels"].long()
            metrics = {k: float(v) for k, v in step(batch, z_rng).items()}
            line = json.dumps({"step": state.step, "seconds": time.perf_counter() - t0, **metrics})
            print(line, flush=True)
            log.write(line + "\n")
    torch.save(gen.state_dict(), os.path.join(args.out_path, "G.pth"))
    torch.save(disc.state_dict(), os.path.join(args.out_path, "D.pth"))
    print(f"wrote G.pth and D.pth after {state.step} steps to {args.out_path}")


if __name__ == "__main__":
    main()
