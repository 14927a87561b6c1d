"""Sampling CLI (counterpart of ``layout2img_tpu/cli/sample.py``) for any
LostGAN-family experiment (``--model``, default ``context_app_v2``; the map
is ``cli/presets.py``): load a generator, iterate layouts, draw
``--num_img`` truncated-normal samples per layout and write
``sample{idx}_numb{j}.jpg``.

    python -m layout2img_tpu_torch.cli.sample --model context_app_v2 \\
        --ckpt_dir out/coco/128/context_app_v2/ckpt --dataset coco \\
        --coco_image_dir ... --coco_instances ... --coco_stuff ... --sample_path samples

The generator comes from one of:
- ``--ckpt_dir``: the newest checkpoint of ``cli.train`` (its EMA when it
  has one);
- ``--torch_ckpt``: a reference ``.pth``, run with ``legacy_attention`` as
  the reference's checkpoints need;
- ``--weights``: a reference-format dict written by the port
  (``cli.train``'s ``G.pth``/``G_ema.pth``, ``cli.export_torch``) or by
  ``python -m layout2img_tpu.cli.export_torch``.

Layouts: ``--dataset coco|vg`` iterates the val split in order (no flips,
no shuffle; the last batch edge-padded to ``--batch_size`` and its padding
dropped), up to ``--max_layouts``; ``--dataset synthetic`` (default) draws
four batches of COCO-shaped layouts over the generator's classes.

The generator's sizes are read off its weights: ``--ch`` and ``--img_size``
(the JAX CLI's flags) need not be given, and a given one that disagrees with
the weights raises, naming both values. Runs on the GPU; ``--device cpu``
asks for the CPU. ``--obj_budget`` is refused where compaction is not
exact (the v1 mask trunk, legacy attention).

The special families sample from ``--ckpt_dir`` only, as in the JAX CLI
(``layout2img_tpu/cli/sample.py:95-165``), their sizes read off the
checkpoint: ``--model ours_ed`` splits each layout into its fg/bg streams
(``train/step_bgfg.py::make_bgfg_sample_fn``); ``--model layout2im`` runs
``Layout2ImGenerator.sample`` with ``--l2i_fusion`` as trained, on the
layouts' box masks, which ``--bf16`` casts to the serving dtype with the
weights and latents. ``--obj_budget`` is refused for both.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from layout2img_tpu_torch.cli.presets import dataset_spec, experiment
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
    p.add_argument("--ckpt_dir", default="", help="cli.train checkpoint dir (EMA preferred)")
    p.add_argument("--torch_ckpt", default="", help="reference .pth generator (legacy attention)")
    p.add_argument("--weights", default="", help="reference-format generator .pth")
    p.add_argument("--dataset", default="synthetic", choices=["coco", "vg", "synthetic"])
    p.add_argument("--sample_path", default="./samples")
    p.add_argument("--num_img", type=int, default=5)
    p.add_argument("--img_size", type=int, default=0,
                   help="0 = the weights' size; another size than theirs raises")
    p.add_argument("--ch", type=int, default=None,
                   help="the weights' channel width (the JAX CLI's flag; its default there is "
                        "64); read off the weights when not given, and a given width that "
                        "disagrees with them raises")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_layouts", type=int, default=0, help="stop after this many (0 = all)")
    p.add_argument("--truncation", type=float, default=2.0)
    p.add_argument("--l2i_fusion", default="transformer",
                   choices=["transformer", "convlstm", "transformer_decoder", "transformer_noctx"],
                   help="--model layout2im: the fusion it was trained with")
    p.add_argument("--obj_budget", type=int, default=0,
                   help="serve only the first K valid-compacted object slots (0 = all)")
    p.add_argument("--bf16", action="store_true", help="serve in bfloat16 (boxes stay f32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coco_image_dir", default="datasets/coco/images/val2017")
    p.add_argument("--coco_instances", default="datasets/coco/annotations/instances_val2017.json")
    p.add_argument("--coco_stuff", default="datasets/coco/annotations/stuff_val2017.json")
    p.add_argument("--vg_vocab", default="datasets/vg/vocab.json")
    p.add_argument("--vg_h5", default="datasets/vg/val.h5")
    p.add_argument("--vg_image_dir", default="datasets/vg/images")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


_BLOCKS_TO_SIZE = {4: 64, 5: 128, 6: 256}  # the upsampling ResBlocks of each image size


def generator_sizes(sd: dict[str, torch.Tensor]) -> dict[str, int]:
    """The channel width and image size of the LostGAN generator that the
    reference-format dict ``sd`` describes."""
    blocks = {k.split(".")[0] for k in sd if re.fullmatch(r"res\d+", k.split(".")[0])}
    return {"ch": sd["fc.weight_orig"].shape[0] // (4 * 4 * 16),
            "image_size": _BLOCKS_TO_SIZE[len(blocks)]}


def check_sizes(sizes: dict[str, int], ch: int | None = None, image_size: int = 0) -> None:
    """Raise where a given ``--ch`` (None: not given) or ``--img_size`` (0:
    not given) disagrees with the weights' ``sizes``."""
    for flag, given, key in (("--ch", ch, "ch"), ("--img_size", image_size or None, "image_size")):
        if given is not None and given != sizes[key]:
            raise SystemExit(f"{flag} {given} disagrees with the weights, whose {key} is "
                             f"{sizes[key]}")


def load_generator(weights, device: torch.device, model: str = "context_app_v2",
                   legacy_attention: bool = False, image_size: int = 0,
                   ch: int | None = None) -> LostGANGenerator:
    """Build the generator of experiment ``model`` that a reference-format
    dict (or its ``.pth`` path) describes and load it with ``strict=True``.
    Sizes are read off the dict; a given ``image_size`` (0: none) or ``ch``
    (None: none) that disagrees with them raises."""
    from layout2img_tpu_torch.utils.reference import reference_state_dict

    exp = experiment(model)
    sd = reference_state_dict(weights)
    sizes = generator_sizes(sd)
    check_sizes(sizes, ch, image_size)
    if "alpha1" in sd:  # stage masks pick their masks by label
        sizes["num_mask_classes"] = sd["alpha1"].shape[1]
    gen = make_generator(exp.gen_preset, sd["label_embedding.weight"].shape[0], device=device,
                         legacy_attention=legacy_attention, **sizes)
    gen.load_state_dict(sd, strict=True)
    return gen


def checkpoint_generator_dict(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """The generator's reference-format dict in the newest checkpoint of
    ``ckpt_dir``, with the EMA in place of its parameters when the
    checkpoint has one."""
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager

    ck = CheckpointManager(ckpt_dir).read()
    return {**ck["generator"], **ck.get("ema", {})}


def pad_tail(batch: dict, target: int) -> tuple[dict, int]:
    """Edge-pad a ragged last batch to ``target`` rows; returns it and the
    count of real rows."""
    n = np.asarray(batch["labels"]).shape[0]
    if n == target:
        return batch, n
    reps = np.concatenate([np.arange(n), np.full(target - n, n - 1)])
    return {k: np.asarray(v)[reps] for k, v in batch.items()}, n


def write_images(images: np.ndarray, sample_path: str, first: int, j: int) -> None:
    """(n, 3, h, w) in [-1, 1] -> ``sample{first + k}_numb{j}.jpg``."""
    import PIL.Image

    imgs = np.clip(images.transpose(0, 2, 3, 1) * 0.5 + 0.5, 0, 1)
    for k in range(imgs.shape[0]):
        PIL.Image.fromarray((imgs[k] * 255).astype(np.uint8)).save(
            os.path.join(sample_path, f"sample{first + k}_numb{j}.jpg"))


def layout_batches(args, num_classes: int):
    """{"boxes", "labels"} numpy batches of the run's layouts."""
    if args.dataset == "synthetic":
        rng = np.random.default_rng(args.seed)
        for _ in range(SYNTHETIC_BATCHES):
            yield synthetic_layouts(rng, args.batch_size, SYNTHETIC_OBJECTS, num_classes)
        return
    from layout2img_tpu_torch.cli.train import build_dataset

    for batch in build_dataset(args, dataset_spec(args.dataset)[1], eval_mode=True):
        yield {"boxes": batch["boxes"], "labels": batch["labels"]}


def special_sampler(args, device: torch.device, dtype: torch.dtype):
    """(sample(batch, rng) -> images, its generator's class count) for a
    special family's newest checkpoint in ``--ckpt_dir``."""
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager

    sd = CheckpointManager(args.ckpt_dir).read()["generator"]
    if args.model == "ours_ed":
        from layout2img_tpu_torch.data.coco import split_fg_bg_batch
        from layout2img_tpu_torch.models.generators import BgFgGenerator
        from layout2img_tpu_torch.train.step_bgfg import make_bgfg_sample_fn

        num_bg = sd["background_g.label_embedding.weight"].shape[0]
        ch = sd["final.2.weight_orig"].shape[1]
        check_sizes({"ch": ch}, args.ch)
        gen = BgFgGenerator(sd["foreground_g.label_embedding.weight"].shape[0], num_bg, ch=ch)
        gen.load_state_dict(sd, strict=True)
        cast_floating(gen.to(device).eval(), dtype)
        draw = make_bgfg_sample_fn(gen, truncation=args.truncation, dtype=dtype)
        return (lambda batch, rng: draw(split_fg_bg_batch(batch), rng)), 91 + num_bg

    from layout2img_tpu_torch.models.layout2im import Layout2ImGenerator
    from layout2img_tpu_torch.train.step_layout2im import make_layout2im_sample_fn

    num_classes = sd["crop_encoder.bn1.gamma.weight"].shape[0]
    gen = Layout2ImGenerator(num_classes, fusion=args.l2i_fusion,
                             z_dim=sd["crop_encoder.fc_mu.weight"].shape[0],
                             conv_dim=sd["decoder.c4.weight"].shape[1])
    gen.load_state_dict(sd, strict=True)
    cast_floating(gen.to(device).eval(), dtype)
    return make_layout2im_sample_fn(gen, truncation=args.truncation, dtype=dtype), num_classes


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if experiment(args.model).special:
        return main_special(args, device)
    sources = [s for s in ("ckpt_dir", "torch_ckpt", "weights") if getattr(args, s)]
    if len(sources) != 1:
        raise SystemExit("give one of --ckpt_dir, --torch_ckpt and --weights")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    weights = (checkpoint_generator_dict(args.ckpt_dir) if args.ckpt_dir
               else args.torch_ckpt or args.weights)
    gen = load_generator(weights, device, args.model, legacy_attention=bool(args.torch_ckpt),
                         image_size=args.img_size, ch=args.ch)
    args.img_size = gen.image_size
    why = obj_budget_error(gen) if args.obj_budget else None
    if why is not None:
        raise SystemExit(f"--obj_budget is not exact for this model: {why}")
    cast_floating(gen, dtype)
    sample = make_sample_fn(gen, z_dim=gen.z_dim, truncation=args.truncation, dtype=dtype,
                            obj_budget=args.obj_budget)

    write_samples(args, lambda batch, rng: sample(torch.from_numpy(batch["boxes"]),
                                                  torch.from_numpy(batch["labels"]), rng),
                  gen.label_embedding.num_embeddings, device)


def write_samples(args, draw, num_classes: int, device: torch.device) -> None:
    """``--num_img`` draws of ``draw(batch, rng)`` for each batch of the
    run's layouts, written as JPEGs; latents from ``--seed``."""
    os.makedirs(args.sample_path, exist_ok=True)
    z_rng = torch.Generator(device=device).manual_seed(args.seed)
    idx = 0
    for batch in layout_batches(args, num_classes):
        batch, n = pad_tail(batch, args.batch_size)
        for j in range(args.num_img):
            write_images(draw(batch, z_rng).float().cpu().numpy()[:n], args.sample_path, idx, j)
        idx += n
        if args.max_layouts and idx >= args.max_layouts:
            break
    print(f"wrote {idx} layouts x {args.num_img} samples to {args.sample_path}")


def main_special(args, device: torch.device) -> None:
    """``cli.sample`` for ``--model ours_ed`` and ``--model layout2im``."""
    if not args.ckpt_dir or args.torch_ckpt or args.weights:
        raise SystemExit(f"{args.model} sampling requires --ckpt_dir (and no other source)")
    if args.obj_budget:
        raise SystemExit(f"--obj_budget is a LostGAN-family flag; --model {args.model} has no "
                         "object-budget serving path")
    if args.img_size not in (0, 64):
        raise SystemExit(f"--model {args.model} is a 64px family; got --img_size {args.img_size}")
    args.img_size = 64
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    write_samples(args, *special_sampler(args, device, dtype), device)


if __name__ == "__main__":
    main()
