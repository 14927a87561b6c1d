"""Export a ``cli.train`` checkpoint as reference-format ``.pth`` files
(counterpart of ``layout2img_tpu/cli/export_torch.py``).

    python -m layout2img_tpu_torch.cli.export_torch \\
        --ckpt_dir out/coco/128/context_app_v2/ckpt --out_g G_200.pth --out_d D_200.pth

The port's networks carry the reference's names, so the checkpoint's state
dicts are already in the reference's format: the generator's (with the EMA
in place of its parameters when the checkpoint has one, unless
``--no_ema``) loads with ``strict=True`` in the reference's test scripts and
in ``cli.sample --weights``; the discriminator's is written under the
reference's ``obD.`` inner-module prefix, as ``CombineDiscriminator*``
wrappers hold it (``cli.train --torch_ckpt_d`` strips it).
``--module_prefix`` prepends ``module.`` (a DataParallel save). The newest
checkpoint is exported. Runs on the host. The JAX CLI's ``--dataset``,
``--ch`` and ``--img_size`` are accepted; the sizes are read off the
checkpoint, and a given ``--ch`` or ``--img_size`` that disagrees with it
raises, naming both values.

``--model`` names the checkpoint's experiment: ``ours_ed`` exports the
two-stream generator in the reference's ``background_foreground_generator``
format (and its ``d64`` under ``obD.``); ``layout2im`` is refused, as in the
JAX CLI: the reference's layout2im fork stores its checkpoints in another
format.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="context_app_v2", help="the checkpoint's experiment")
    p.add_argument("--dataset", default="coco", choices=["coco", "vg", "synthetic"],
                   help="the JAX CLI's flag; the port reads the class count off the checkpoint")
    p.add_argument("--ckpt_dir", required=True, help="cli.train checkpoint dir")
    p.add_argument("--out_g", default="", help="output .pth for the generator")
    p.add_argument("--out_d", default="", help="output .pth for the discriminator")
    p.add_argument("--ch", type=int, default=None,
                   help="the checkpoint's channel width (the JAX CLI's flag, default 64 there); "
                        "read off the checkpoint when not given, and a given width that "
                        "disagrees with it raises")
    p.add_argument("--img_size", type=int, default=0,
                   help="0 = the checkpoint's size; another size than its own raises")
    p.add_argument("--no_ema", action="store_true",
                   help="export the raw G weights even if EMA weights exist")
    p.add_argument("--module_prefix", action="store_true",
                   help="prepend 'module.' (DataParallel-style save)")
    return p.parse_args(argv)


def main(argv=None):
    from layout2img_tpu_torch.cli.sample import check_sizes, generator_sizes
    from layout2img_tpu_torch.train.checkpoint import CheckpointManager

    args = parse_args(argv)
    if not args.out_g and not args.out_d:
        raise SystemExit("nothing to do: pass --out_g and/or --out_d")
    if args.model == "layout2im":
        raise SystemExit("layout2im has no torch export: the reference's layout2im fork stores "
                         "checkpoints in a different format (SURVEY.md §2.3)")
    ck = CheckpointManager(args.ckpt_dir).read()
    if ("combination.conv1.weight" in ck["generator"]) != (args.model == "ours_ed"):
        raise SystemExit(f"the checkpoint in {args.ckpt_dir} is not a --model {args.model} one")
    if args.model == "ours_ed":
        check_sizes({"ch": ck["generator"]["final.2.weight_orig"].shape[1], "image_size": 64},
                    args.ch, args.img_size)
    else:
        check_sizes(generator_sizes(ck["generator"]), args.ch, args.img_size)
    prefix = "module." if args.module_prefix else ""
    if args.out_g:
        sd = {**ck["generator"], **({} if args.no_ema else ck.get("ema", {}))}
        torch.save({prefix + k: v for k, v in sd.items()}, args.out_g)
        print(f"wrote generator (step {ck['step']}"
              f"{', EMA' if 'ema' in ck and not args.no_ema else ''}) -> {args.out_g}")
    if args.out_d:
        torch.save({f"{prefix}obD.{k}": v for k, v in ck["discriminator"].items()}, args.out_d)
        print(f"wrote discriminator (step {ck['step']}) -> {args.out_d}")


if __name__ == "__main__":
    main()
