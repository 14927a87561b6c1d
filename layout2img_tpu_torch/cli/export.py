"""Export a generator as a ``torch.export`` program for serving (counterpart of
``layout2img_tpu/cli/export.py``).

    python -m layout2img_tpu_torch.cli.export --model context_app_v2 \\
        --ckpt_dir out/coco/128/context_app_v2/ckpt --out generator.pt2 --batch_size 8
    python -m layout2img_tpu_torch.cli.export --run generator.pt2

The artifact is ``serve(boxes, labels, seed) -> images``: boxes (b, o, 4) f32
xywh, labels (b, o) int64, seed (1,) int64 -> (b, 3, s, s) in [-1, 1], at the
b and o it was exported for. It draws its truncated-normal latents inside
from the seed (``sample.py::latents_from_seed``: torch ops, not JAX's
threefry) and holds the generator's weights: the checkpoint's EMA when it has
one, as ``cli.sample`` serves, else its raw weights; without ``--ckpt_dir``,
seeded random weights. ``--bf16`` bakes bf16 weights and latents (boxes stay
f32). Beside ``--out`` goes the JAX CLI's sidecar ``<out>.json`` (batch size,
object slots, class count, image size, model).

On the card the program calls the ISLA kernels through their
``torch.library`` operators (``ops/isla.py``), ten forward launches a call;
exported on the CPU (``--device cpu``) it holds their plain versions.
``--run`` loads the artifact with ``torch.export.load`` and runs one batch
(the JAX CLI's layouts: ``np.random.default_rng(0)``, seed 0) without the
model code: it imports ``layout2img_tpu_torch.ops``, which registers the
operators, and no module of ``models/``. It runs on the device the artifact
was exported on, which ``--device`` must name (default cuda).

The sizes: with ``--ckpt_dir`` they are read off the checkpoint, and a given
``--ch`` or ``--img_size`` that disagrees raises; without, ``--ch`` (default
64) and ``--img_size`` (default the experiment's) size the random generator.
The special families (``ours_ed``, ``layout2im``) are refused, as the JAX
CLI's ``make_generator`` builds neither.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

from layout2img_tpu_torch.device import resolve_device

DEFAULT_CH = 64  # the JAX CLI's --ch default


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="context_app_v2")
    p.add_argument("--dataset", default="coco", choices=["coco", "vg", "synthetic"])
    p.add_argument("--ckpt_dir", default="", help="cli.train checkpoint dir (EMA preferred)")
    p.add_argument("--out", default="generator.pt2")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--img_size", type=int, default=0,
                   help="0 = the checkpoint's size, or without one the experiment's")
    p.add_argument("--ch", type=int, default=None,
                   help=f"the checkpoint's width (read off it when not given); without a "
                        f"checkpoint the random generator's (default {DEFAULT_CH})")
    p.add_argument("--truncation", type=float, default=2.0)
    p.add_argument("--bf16", action="store_true",
                   help="bake bfloat16 weights and latents into the artifact (serving "
                        "precision; boxes stay f32)")
    p.add_argument("--run", default="", help="load an exported artifact and run one batch")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


class SeededSampler(nn.Module):
    """``serve(boxes, labels, seed)``: the eval-mode generator on latents drawn
    from ``seed`` at a fixed b and o."""

    def __init__(self, generator: nn.Module, b: int, o: int, truncation: float,
                 dtype: torch.dtype):
        super().__init__()
        self.generator = generator.eval()
        self.b, self.o, self.truncation, self.dtype = b, o, truncation, dtype

    def forward(self, boxes: torch.Tensor, labels: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        # imported here: sample.py imports the model code, which --run must not load
        from layout2img_tpu_torch.sample import latents_from_seed

        z, z_im = latents_from_seed(seed, self.b, self.o, self.generator.z_dim, self.truncation,
                                    self.dtype)
        return self.generator(z, boxes, labels, z_im)


def run_layouts(b: int, o: int, num_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX CLI's ``--run`` batch: boxes (b, o, 4) f32 and labels (b, o)
    from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.random((b, o, 2)) * 0.5, rng.random((b, o, 2)) * 0.4 + 0.1],
                           -1).astype(np.float32)
    labels = rng.integers(1, num_classes, (b, o)).astype(np.int32)
    return boxes, labels


def run_artifact(path: str, device: torch.device) -> torch.Tensor:
    """Load the artifact at ``path`` and run it once on ``run_layouts`` and
    seed 0; prints the JAX CLI's line and returns the images."""
    import layout2img_tpu_torch.ops  # noqa: F401  (registers the ISLA operators)

    ep = torch.export.load(path)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    held = {t.device.type for t in ep.state_dict.values()}
    if held != {device.type}:
        raise SystemExit(f"{path} holds its weights on {sorted(held)}; run it with "
                         f"--device {' or '.join(sorted(held))}")
    boxes, labels = run_layouts(meta.get("batch_size", 8), meta.get("num_objects", 8),
                                meta.get("num_classes", 184))
    with torch.no_grad():
        imgs = ep.module()(torch.from_numpy(boxes).to(device),
                           torch.from_numpy(labels).to(device, torch.long),
                           torch.zeros(1, dtype=torch.long, device=device))
    print("ran exported artifact:", tuple(imgs.shape), "range", float(imgs.min()),
          float(imgs.max()))
    return imgs


def build_generator(args, device: torch.device) -> nn.Module:
    """The generator the artifact serves, in f32 on ``device``."""
    from layout2img_tpu_torch.cli.presets import dataset_spec, experiment

    exp = experiment(args.model)
    if exp.special:
        raise SystemExit(f"--model {args.model} is a special family: cli.export serves the "
                         "LostGAN experiments only, as the JAX CLI's make_generator builds none "
                         "of the special families")
    if args.ckpt_dir:
        from layout2img_tpu_torch.cli.sample import checkpoint_generator_dict, load_generator

        return load_generator(checkpoint_generator_dict(args.ckpt_dir), device, args.model,
                              image_size=args.img_size, ch=args.ch)
    from layout2img_tpu_torch.utils.convert import init_generator

    print("WARNING: no --ckpt_dir; exporting randomly-initialized params")
    return init_generator(0, dataset_spec(args.dataset)[0], preset=exp.gen_preset, device=device,
                          ch=args.ch or DEFAULT_CH, image_size=args.img_size or exp.image_size)


def export(args, device: torch.device) -> torch.export.ExportedProgram:
    """Write the artifact and its sidecar; returns the exported program."""
    from layout2img_tpu_torch.cli.presets import dataset_spec
    from layout2img_tpu_torch.utils.casting import cast_floating

    gen = build_generator(args, device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cast_floating(gen, dtype)
    num_classes = gen.label_embedding.num_embeddings
    b, o = args.batch_size, dataset_spec(args.dataset)[1]
    example = (torch.full((b, o, 4), 0.25, device=device),
               torch.ones((b, o), dtype=torch.long, device=device),
               torch.zeros(1, dtype=torch.long, device=device))
    with torch.no_grad():
        ep = torch.export.export(SeededSampler(gen, b, o, args.truncation, dtype), example,
                                 strict=False)
    torch.export.save(ep, args.out)
    with open(args.out + ".json", "w") as f:
        json.dump({"batch_size": b, "num_objects": o, "num_classes": num_classes,
                   "img_size": gen.image_size, "model": args.model}, f)
    print(f"exported {args.model} -> {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return ep


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.run:
        run_artifact(args.run, device)
        return
    export(args, device)


if __name__ == "__main__":
    main()
