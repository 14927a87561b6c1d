"""Sampling CLI (counterpart of ``layout2img_tpu/cli/sample.py``) for any
LostGAN-family experiment (``--model``, default ``context_app_v2``; the map
is ``cli/presets.py``): load a reference-format generator state dict (for
example one written by ``python -m layout2img_tpu.cli.export_torch --out_g``
or by ``cli.train``) into the experiment's generator, draw ``--num_img``
truncated-normal samples per layout and write ``sample{idx}_numb{j}.jpg``.

    python -m layout2img_tpu_torch.cli.sample --model context_app_v2 --weights G.pth \\
        --dataset synthetic --sample_path samples --num_img 2 --batch_size 8

Runs on the GPU; ``--device cpu`` asks for the CPU. ``--obj_budget`` is
refused where compaction is not exact (the v1 mask trunk); the special
families raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from layout2img_tpu_torch.cli.presets import experiment
from layout2img_tpu_torch.data.synthetic import synthetic_layouts
from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.models.generators import (LostGANGenerator, make_generator,
                                                   obj_budget_error)
from layout2img_tpu_torch.sample import make_sample_fn
from layout2img_tpu_torch.utils.casting import cast_floating

SYNTHETIC_OBJECTS = 8  # the JAX CLI's synthetic shape (COCO: o=8)
SYNTHETIC_BATCHES = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="context_app_v2",
                   help="experiment preset (cli/presets.py) whose generator the weights fill")
    p.add_argument("--weights", required=True, help="reference-format generator .pth")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic"],
                   help="COCO and VG loaders are not ported yet")
    p.add_argument("--sample_path", default="./samples")
    p.add_argument("--num_img", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--obj_budget", type=int, default=0,
                   help="serve only the first K valid-compacted object slots (0 = all)")
    p.add_argument("--bf16", action="store_true", help="serve in bfloat16 (boxes stay f32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def load_generator(path: str, device: torch.device,
                   model: str = "context_app_v2") -> LostGANGenerator:
    """Build the generator of experiment ``model`` that a reference-format
    dict describes and load it with ``strict=True``. Sizes are read off the
    dict."""
    preset = experiment(model).gen_preset
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    sizes = dict(ch=sd["fc.weight_orig"].shape[0] // (4 * 4 * 16))
    if "alpha1" in sd:  # stage masks pick their masks by label
        sizes["num_mask_classes"] = sd["alpha1"].shape[1]
    gen = make_generator(preset, sd["label_embedding.weight"].shape[0], device=device, **sizes)
    gen.load_state_dict(sd, strict=True)
    return gen


def write_images(images: np.ndarray, sample_path: str, first: int, j: int) -> None:
    """(n, 3, h, w) in [-1, 1] -> ``sample{first + k}_numb{j}.jpg``."""
    import PIL.Image

    imgs = np.clip(images.transpose(0, 2, 3, 1) * 0.5 + 0.5, 0, 1)
    for k in range(imgs.shape[0]):
        PIL.Image.fromarray((imgs[k] * 255).astype(np.uint8)).save(
            os.path.join(sample_path, f"sample{first + k}_numb{j}.jpg"))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    gen = load_generator(args.weights, device, args.model)
    why = obj_budget_error(gen) if args.obj_budget else None
    if why is not None:
        raise SystemExit(f"--obj_budget is not exact for this model: {why}")
    cast_floating(gen, dtype)
    sample = make_sample_fn(gen, z_dim=gen.z_dim, dtype=dtype, obj_budget=args.obj_budget)
    num_classes = gen.label_embedding.num_embeddings

    os.makedirs(args.sample_path, exist_ok=True)
    layout_rng = np.random.default_rng(args.seed)
    z_rng = torch.Generator(device=device).manual_seed(args.seed)
    idx = 0
    for _ in range(SYNTHETIC_BATCHES):
        batch = synthetic_layouts(layout_rng, args.batch_size, SYNTHETIC_OBJECTS, num_classes)
        boxes, labels = torch.from_numpy(batch["boxes"]), torch.from_numpy(batch["labels"])
        for j in range(args.num_img):
            images = sample(boxes, labels, z_rng).float().cpu().numpy()
            write_images(images, args.sample_path, idx, j)
        idx += args.batch_size
    print(f"wrote {idx} layouts x {args.num_img} samples to {args.sample_path}")


if __name__ == "__main__":
    main()
