"""Training CLI (counterpart of ``layout2img_tpu/cli/train.py``): any
LostGAN-family experiment (``--model``, default ``context_app_v2``: the
Ours-D 128px generator ``ours_d_context128`` against ``d128_app``; the map
is ``cli/presets.py``) on COCO-Stuff, Visual Genome or synthetic batches,
with the JAX CLI's flags and their meanings.

    python -m layout2img_tpu_torch.cli.train --model context_app_v2 --dataset coco \\
        --coco_image_dir ... --coco_instances ... --coco_stuff ... \\
        [--total_epoch 200] [--batch_size 16] [--resume] [--save_every_epochs 5] \\
        [--async_ckpt] [--log_every 500] [--mixed_precision] [--ema_decay 0.999] ...
    python -m layout2img_tpu_torch.cli.train --dataset synthetic --steps 5 --batch_size 8

The run writes under ``<out_path>/<dataset>/<img_size>/<model>/``:
``ckpt/<step>/state.pt`` (``train/checkpoint.py``: the whole train state,
the 5 newest kept), ``metrics.jsonl`` and ``log.txt``, the fake and real
grids under ``images/`` at each ``--log_every``, and at the end ``G.pth``
and ``D.pth`` (reference-format state dicts, which ``cli.sample --weights``
loads) and, with ``--ema_decay``, ``G_ema.pth`` (the EMA parameters with
the live generator's buffers). ``--steps N`` caps the steps this run takes
(0: no cap); ``--steps_per_epoch`` sizes a synthetic epoch (default 50).

- Data: the dataset's loader (``data/coco.py``, ``data/vg.py``; the native
  JPEG decoder where it builds, else PIL) feeds ``data/prefetch.py``, which
  copies batches to the card two steps ahead. COCO and VG double each
  epoch with mirrored images; each epoch's order is drawn from
  ``seed + epoch``, the epoch counted from 0 by each run.
- Resume (``--resume``) restores the newest checkpoint bit for bit and the
  step count continues. As in the JAX CLI, the loader's epoch count and the
  latent generator (seeded with ``--seed``) restart, so a resumed run does
  not draw the batches and latents an uninterrupted run would have.
- Metrics reach the host only at ``--log_every`` and before each save.
- NaN guard (on unless ``--no_nan_guard``): non-finite metrics at a log
  point or before a save keep the last good checkpoint and exit 3;
  ``--fault_inject_nan_at N`` poisons the metrics read from step N on.
- SIGTERM: the step in flight finishes, the state is saved, exit 0.
- ``--eval_every N`` (``train/eval_hook.py``): every N steps, the
  generator (its EMA when there is one) samples a frozen pool of the first
  ``ceil(--eval_n / --batch_size)`` loader batches' layouts with frozen
  latents, and ``rel_fid`` against the pool's real images (and, with
  ``--inception_weights``, ``is_mean``/``is_std``) goes to
  ``metrics.jsonl`` and ``log.txt``; without weights Inception has seeded
  random filters and rel-FID is a relative trajectory only.
- ``--torch_ckpt_g/--torch_ckpt_d`` fine-tune from reference ``.pth``
  files (the generator with ``legacy_attention``; their Adam moments
  restart), ``--vgg_weights`` loads torchvision VGG19 features (else seeded
  random filters), ``--profile_dir`` writes a ``torch.profiler`` trace of
  steps 10-20, which carries the program's spans (``utils/tracing.py``):
  ``train.step`` over ``train.cast``, ``train.g_forward``,
  ``train.d_forward`` (with ``d.objects``), ``train.vgg``,
  ``train.backward``, ``train.adam``, ``train.ema`` and
  ``mesh.all_reduce``, and ``data.wait`` between steps;
  ``tracing.enable(True)`` records them without a profiler, into an
  in-memory ring a script reads (``tracing.records()``).
  ``--tensorboard`` mirrors the metrics into tensorboardX.

Without ``--mixed_precision`` the step runs in f32 with TF32 off in cuDNN
and matmul, as the JAX package's default ``TrainConfig`` does. The object
budgets are checked against the dataset's valid-object counts. Runs on the
GPU; ``--device cpu`` asks for the CPU.

Data parallelism (``parallel/mesh.py``; ``scripts/launch_multihost.py``):

    torchrun --nproc_per_node=N -m layout2img_tpu_torch.cli.train --batch_size 16 ...

Under a launcher each process is a rank on ``cuda:{LOCAL_RANK}`` over NCCL
(``--device cpu``: gloo), ``--batch_size`` is per process, so
the global batch is ``batch_size * WORLD_SIZE``; each rank loads its own
shard (``HostDataLoader(process_id=rank)``; the synthetic dataset is seeded
``seed + rank``), rank 0's initial state is broadcast, and the step is the
one-process step at the global batch (global latents, BN statistics, masked
means and gradients). Only rank 0 writes logs, metrics, images and
checkpoints (after a barrier); every rank restores on ``--resume``. The NaN
guard's verdict is taken over every rank's metrics (the metrics are the
ranks' mean), so all ranks stop together; SIGTERM flags are OR-reduced
every ``--preempt_sync_every`` steps (default 25) and every rank breaks on the
reduced flag. ``--async_ckpt`` stays one-process only, as in the JAX CLI.

The 2-D mesh (``--model_parallel M --mp_mode tensor|spatial``, JAX's flags;
``parallel/mesh.py::make_mesh_2d``), for the LostGAN trainer on one node:

    torchrun --nproc_per_node=N -m layout2img_tpu_torch.cli.train --model_parallel M \\
        --mp_mode spatial --batch_size 8 ...

M adjacent ranks form a model group; N must divide by M. ``--batch_size``
is per model group, so the global batch is ``batch_size * N / M``; every
rank of a group loads the same examples (``HostDataLoader(process_id=``
its data group``)``). ``tensor`` holds 1/M of every conv, dense and
embedding weight whose output features divide by M, with its Adam moments
and EMA, on each rank; ``spatial`` cuts the images and G's and D's
activations into M shards of rows. Checkpoints, ``G.pth``/``D.pth`` and
``G_ema.pth`` hold whole tensors (a 2-D checkpoint resumes in one process
and the other way round). The special families ignore both flags, as in the
JAX CLI, and say so in the log.

The special families (``layout2img_tpu/cli/train.py::main_special``), 64 px
only, through the same loop (resume, saves, SIGTERM, NaN guard and drill,
``--eval_every``, ``--async_ckpt``) and the same output layout, with no fake
grids and no ``.pth`` files at the end (the checkpoint is the output):

- ``--model ours_ed``: ``BgFgGenerator`` (``--ch``; the foreground streams
  over classes 1-90, the background over the rest, shifted by -91) against
  ``d64``, ``train/step_bgfg.py``; each batch is split into the two streams
  (``data.coco.split_fg_bg_batch``). ``--mixed_precision`` is accepted and
  the step stays f32, as in the JAX package.
- ``--model layout2im``: ``Layout2ImGenerator(fusion=--l2i_fusion)`` at the
  JAX CLI's width (conv_dim 64 whatever ``--ch``) against the image and
  object discriminators at ``--ch``, ``train/step_layout2im.py``.

The object budgets are refused for them as in the JAX CLI, and so are the
LostGAN step's knobs, which have no path there (``--ema_decay``,
``--fused_d``, ``--remat``, ``--remat_d_blocks``, ``--torch_ckpt_g/d``,
``--profile_dir``).
"""

from __future__ import annotations

import argparse
import itertools
import logging
import math
import os
import signal

import numpy as np
import torch

from layout2img_tpu_torch.cli.presets import EXPERIMENTS, dataset_spec, experiment

SYNTHETIC_CLASSES, SYNTHETIC_OBJECTS = dataset_spec("synthetic")
logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="context_app_v2",
                   help="experiment preset (cli/presets.py): G, D and image size")
    p.add_argument("--dataset", default="synthetic", choices=["coco", "vg", "synthetic"],
                   help="default synthetic (the JAX CLI's default is coco, whose files a "
                        "checkout does not hold)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--total_epoch", type=int, default=200)
    p.add_argument("--steps", type=int, default=0,
                   help="the most steps this run takes (0 = no cap)")
    p.add_argument("--steps_per_epoch", type=int, default=0, help="synthetic only (0 = 50)")
    p.add_argument("--d_lr", type=float, default=1e-4)
    p.add_argument("--g_lr", type=float, default=1e-4)
    p.add_argument("--out_path", default="./outputs/tmp")
    p.add_argument("--img_size", type=int, default=0,
                   help="0 = the preset's size; smaller sizes are debug runs, larger refused")
    p.add_argument("--ch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="continue from the newest checkpoint")
    p.add_argument("--save_every_epochs", type=int, default=5)
    p.add_argument("--async_ckpt", action="store_true",
                   help="snapshot the state on the card and write it in a background thread")
    p.add_argument("--log_every", type=int, default=500,
                   help="steps between metric lines, image grids and NaN checks")
    p.add_argument("--no_nan_guard", dest="nan_guard", action="store_false", default=True,
                   help="do not stop on non-finite metrics (by default: keep the last good "
                        "checkpoint and exit 3)")
    p.add_argument("--fault_inject_nan_at", type=int, default=0,
                   help="drills: poison the metrics read from this step on with NaN (0 = off)")
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror metrics and grids into tensorboardX event files under <run>/tb")
    p.add_argument("--no_vgg", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute over f32 master weights")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="generator EMA decay (e.g. 0.999); 0 disables. Also writes G_ema.pth")
    p.add_argument("--fused_d", action="store_true",
                   help="one 2b-batch D call for real+fake (score-identical)")
    p.add_argument("--remat", default="none", choices=["none", "g", "d", "gd"],
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
    p.add_argument("--torch_ckpt_g", default="",
                   help="reference G .pth to fine-tune from (built with legacy_attention)")
    p.add_argument("--torch_ckpt_d", default="", help="reference D .pth to fine-tune from")
    p.add_argument("--vgg_weights", default="", help="torchvision vgg19 .pth for the VGG loss")
    p.add_argument("--profile_dir", default="", help="write a torch.profiler trace of steps 10-20")
    p.add_argument("--coco_image_dir", default="datasets/coco/images/train2017")
    p.add_argument("--coco_instances", default="datasets/coco/annotations/instances_train2017.json")
    p.add_argument("--coco_stuff", default="datasets/coco/annotations/stuff_train2017.json")
    p.add_argument("--vg_vocab", default="datasets/vg/vocab.json")
    p.add_argument("--vg_h5", default="datasets/vg/train.h5")
    p.add_argument("--vg_image_dir", default="datasets/vg/images")
    p.add_argument("--eval_every", type=int, default=0,
                   help="every N steps, sample a frozen real-layout pool and log rel-FID (+ IS "
                        "with --inception_weights) to the metric stream (0 = off)")
    p.add_argument("--eval_n", type=int, default=64,
                   help="images in the frozen eval pool (rounded up to whole batches)")
    p.add_argument("--inception_weights", default="",
                   help="torchvision inception_v3 .pth for --eval_every (none = fixed-seed random "
                        "filters; rel-FID is then a relative trajectory, IS is skipped)")
    p.add_argument("--l2i_fusion", default="transformer",
                   choices=["transformer", "convlstm", "transformer_decoder", "transformer_noctx"],
                   help="--model layout2im: the layout encoder's fusion over objects")
    p.add_argument("--preempt_sync_every", type=int, default=25,
                   help="under a launcher: steps between OR-reductions of the ranks' SIGTERM "
                        "flags (each one syncs the host with the card; the grace period must "
                        "cover N steps and a save)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks per model group on a (data, model) mesh; 1 = data parallel only")
    p.add_argument("--mp_mode", default="tensor", choices=["tensor", "spatial"],
                   help="model-axis sharding: 'tensor' shards the weights' output features and "
                        "their Adam moments; 'spatial' shards the image rows")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def check_img_size(args, exp) -> None:
    """Set ``args.img_size`` to the preset's size when 0; refuse a larger
    one, which has no correct model config (``layout2img_tpu/cli/train.py:288-303``)."""
    if args.img_size == 0:
        args.img_size = exp.image_size
    if args.img_size > exp.image_size:
        alt = next((name for name, e in EXPERIMENTS.items()
                    if e.image_size == args.img_size and not e.special), None)
        hint = f" — use --model {alt}" if alt else ""
        raise SystemExit(f"--model {args.model} is a {exp.image_size}px experiment; --img_size "
                         f"{args.img_size} has no correct config{hint}. (Sizes below "
                         f"{exp.image_size} are accepted as debug runs.)")


def build_dataset(args, num_objects: int, eval_mode: bool = False, fg_bg: bool = False):
    """The run's batch source: a ``HostDataLoader`` over COCO or VG, or a
    ``SyntheticLayoutDataset``. ``eval_mode``: no flip doubling, no
    shuffle, the tail batch kept (the reference's test protocol). ``fg_bg``:
    COCO items carry the Ours-ED streams. Each data-parallel rank loads its
    own shard of every global batch (``--batch_size`` is per process; on the
    2-D mesh per model group, whose ranks load the same shard); the
    synthetic dataset is seeded ``seed +`` the shard's index."""
    from layout2img_tpu_torch.data.coco import CocoLayoutDataset, HostDataLoader
    from layout2img_tpu_torch.data.synthetic import SyntheticLayoutDataset
    from layout2img_tpu_torch.data.vg import VgLayoutDataset
    from layout2img_tpu_torch.parallel.mesh import current

    mesh = current()
    load = dict(shuffle=not eval_mode, drop_last=not eval_mode, process_id=mesh.data_index,
                process_count=mesh.data_size)
    if args.dataset == "coco":
        ds = CocoLayoutDataset(args.coco_image_dir, args.coco_instances, args.coco_stuff,
                               image_size=args.img_size, left_right_flip=not eval_mode,
                               fg_bg_split=fg_bg)
    elif args.dataset == "vg":
        ds = VgLayoutDataset(args.vg_vocab, args.vg_h5, args.vg_image_dir,
                             image_size=args.img_size, max_objects=num_objects - 1,
                             left_right_flip=not eval_mode)
    else:
        return SyntheticLayoutDataset(args.batch_size, args.img_size, num_objects,
                                      seed=args.seed + mesh.data_index,
                                      steps=args.steps_per_epoch or 50)
    return HostDataLoader(ds, args.batch_size, seed=args.seed, **load)


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


def build_networks(args, exp, device: torch.device):
    """The experiment's generator and discriminator with seeded random
    weights (seeds ``--seed`` and ``--seed + 1``); the generator runs the
    reference's attention scramble when it will take reference weights."""
    from layout2img_tpu_torch.models.generators import obj_budget_error
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator

    num_classes = dataset_spec(args.dataset)[0]
    gen = init_generator(args.seed, num_classes, preset=exp.gen_preset, device=device, ch=args.ch,
                         image_size=args.img_size, legacy_attention=bool(args.torch_ckpt_g))
    if args.g_obj_budget:
        why = obj_budget_error(gen)
        if why is not None:
            raise SystemExit(f"--g_obj_budget is not exact for this model: {why}")
    disc = init_discriminator(args.seed + 1, num_classes, preset=exp.disc_preset, device=device,
                              ch=args.ch, image_size=args.img_size,
                              remat_blocks=args.remat_d_blocks)
    return gen, disc


def main(argv=None):
    from layout2img_tpu_torch.parallel.mesh import launched

    args = parse_args(argv)
    with launched(args.device) as mesh:
        _main(args, mesh)


def _main(args, mesh) -> None:
    from layout2img_tpu_torch.utils.logging import MetricWriter, close_logger, setup_logger

    device = mesh.device
    torch.manual_seed(args.seed)  # the dropout masks: alike on every rank
    if args.async_ckpt and mesh.world > 1:
        raise SystemExit("--async_ckpt is one-process only (as in the JAX CLI); drop it under a "
                         "launcher")
    exp = experiment(args.model)
    if exp.special:
        return main_special(args, device)
    if args.model_parallel > 1:
        mesh = model_parallel_mesh(args, mesh)
    check_img_size(args, exp)
    loader = build_dataset(args, dataset_spec(args.dataset)[1])
    check_obj_budgets(getattr(loader, "dataset", loader).valid_object_counts(), args)
    gen, disc = build_networks(args, exp, device)
    out_dir = os.path.join(args.out_path, args.dataset, str(args.img_size), args.model)
    log = setup_logger("layout2img_tpu_torch", out_dir, rank=mesh.rank)
    writer = MetricWriter(out_dir, rank=mesh.rank, tensorboard=args.tensorboard)
    try:
        train(args, gen, disc, loader, out_dir, log, writer)
    finally:
        writer.close()
        close_logger(log)


def model_parallel_mesh(args, mesh):
    """The (data, model) mesh of ``--model_parallel`` and ``--mp_mode``, made
    current; refused across nodes and where the ranks do not divide."""
    from layout2img_tpu_torch.parallel.mesh import make_mesh_2d

    if mesh.nodes > 1:
        raise SystemExit("--model_parallel runs on one node (its ranks on one host), as the JAX "
                         "CLI runs it in one process")
    try:
        return make_mesh_2d(mesh, args.model_parallel, args.mp_mode)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def train(args, gen: torch.nn.Module, disc: torch.nn.Module, loader, out_dir: str,
          log: logging.Logger, writer) -> None:
    """The loop of ``layout2img_tpu/cli/train.py::main`` on built networks."""
    from layout2img_tpu_torch.parallel.mesh import current, replicate, shard_dims, shard_parameters
    from layout2img_tpu_torch.train.checkpoint import whole_tensors
    from layout2img_tpu_torch.train.eval_hook import make_train_sample_fn
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.reference import load_torch_into_state

    device = next(gen.parameters()).device
    ds = getattr(loader, "dataset", None)
    if ds is not None:
        log.info("%s: %d items, decoder %s", args.dataset, len(ds),
                 "native (libjpeg)" if ds.use_native else "PIL")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(g_lr=args.g_lr, d_lr=args.d_lr, use_vgg_loss=not args.no_vgg,
                      mixed_precision=args.mixed_precision, ema_decay=args.ema_decay,
                      fused_d=args.fused_d, remat=args.remat, d_obj_budget=args.d_obj_budget,
                      g_obj_budget=args.g_obj_budget)
    vgg = _vgg_loss(args, device, log) if cfg.use_vgg_loss else None
    state = create_train_state(gen, disc, cfg)
    if args.torch_ckpt_g or args.torch_ckpt_d:
        load_torch_into_state(state, args.torch_ckpt_g or None, args.torch_ckpt_d or None)
        log.info("fine-tuning from torch checkpoints: G=%s D=%s", args.torch_ckpt_g or "-",
                 args.torch_ckpt_d or "-")
    mesh = current()
    replicate(mesh, state)
    if mesh.mode == "tensor":  # each rank keeps its shards; the optimizers and EMA start on them
        shard_parameters(gen, mesh)
        shard_parameters(disc, mesh)
        state = create_train_state(gen, disc, cfg)
    sample_fn = make_train_sample_fn(gen)

    def fake_grid(batch: dict, step: int) -> torch.Tensor:
        grid_rng = torch.Generator(device=device).manual_seed(step)
        return sample_fn(state.ema, batch["boxes"][:16], batch["labels"][:16], grid_rng)

    evaluator = build_evaluator(args, sample_fn, loader, device, log) if args.eval_every > 0 else None
    precision = "mixed precision" if cfg.mixed_precision else "f32"
    if not run_loop(args, state, make_train_step(state, cfg, vgg_loss=vgg), evaluator, loader,
                    ("images", "labels", "boxes"), out_dir, log, writer, precision,
                    fake_grid=fake_grid):
        raise SystemExit(3)
    g_dims = shard_dims(gen)
    written = {"G.pth": whole_tensors(gen.state_dict(), g_dims),
               "D.pth": whole_tensors(disc.state_dict(), shard_dims(disc))}
    if state.ema is not None:
        written["G_ema.pth"] = whole_tensors(ema_state_dict(gen, state.ema), g_dims)
    if mesh.rank == 0:
        for name, sd in written.items():
            torch.save(sd, os.path.join(out_dir, name))
    log.info("done: %d steps; wrote %s to %s", state.step, ", ".join(written), out_dir)


def _vgg_loss(args, device: torch.device, log: logging.Logger):
    """The VGG perceptual loss: ``--vgg_weights``, else seeded random filters."""
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.utils.convert import init_vgg
    from layout2img_tpu_torch.utils.reference import load_torch_vgg19_features

    if args.vgg_weights:
        return VGGLoss(load_torch_vgg19_features(args.vgg_weights, device))
    log.warning("no --vgg_weights given; using fixed-seed random VGG filters")
    return VGGLoss(init_vgg(args.seed + 2, device=device))


def run_loop(args, state, step_fn, evaluator, loader, keys: tuple[str, ...], out_dir: str,
             log: logging.Logger, writer, precision: str, prepare=None, fake_grid=None) -> bool:
    """The training loop shared by every family: restore the newest
    checkpoint into ``state`` on ``--resume`` (in place, so ``step_fn``,
    built on it, trains on), then per host batch (``prepare``d, its
    ``keys`` copied to the device ahead) one ``step_fn(batch, rng)``;
    metrics, grids (the real images, and ``fake_grid(batch, step)`` when
    given) and NaN checks at ``--log_every``, ``evaluator(state)`` (if any)
    every ``--eval_every`` steps, saves every ``--save_every_epochs`` and at
    the end, the SIGTERM save. Returns False when the run diverged (the last
    good checkpoint kept)."""
    from layout2img_tpu_torch.data.prefetch import device_prefetch
    from layout2img_tpu_torch.parallel.mesh import current
    from layout2img_tpu_torch.train.checkpoint import AsyncSaver, CheckpointManager

    mesh = current()
    device = next(state.generator.parameters()).device
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.info("resumed from step %d", state.step)
    if args.async_ckpt:
        ckpt = AsyncSaver(ckpt)
    log.info("training %s on %s (%s): batch %d, %s, from step %d", args.model, args.dataset,
             device, args.batch_size, precision, state.step)
    if mesh.model > 1:
        log.info("2-D mesh, %s mode: %d ranks = %d data groups x model_parallel %d, batch %d per "
                 "model group, global batch %d", mesh.mode, mesh.world, mesh.data_size,
                 mesh.model, args.batch_size, args.batch_size * mesh.data_size)
    elif mesh.world > 1:
        log.info("data parallel: %d ranks, batch %d per rank, global batch %d", mesh.world,
                 args.batch_size, args.batch_size * mesh.world)

    preempted = {"flag": False}
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: preempted.update(flag=True))
    latest = {"metrics": None, "step": 0}

    def read_metrics(metrics: dict, step: int) -> dict[str, float]:
        m = {k: float(v) for k, v in metrics.items()}
        if args.fault_inject_nan_at and step >= args.fault_inject_nan_at:
            m["d_loss"] = float("nan")  # --fault_inject_nan_at drill
        return m

    def finite(m: dict[str, float]) -> bool:
        """Whether every rank's metrics are finite (one verdict for all)."""
        return not mesh.any(not all(math.isfinite(v) for v in m.values()))

    def metrics_ok() -> bool:
        """The pre-save check: a divergence between log points must not
        reach a save."""
        if not args.nan_guard or latest["metrics"] is None:
            return True
        if finite(read_metrics(latest["metrics"], latest["step"])):
            return True
        log.error("non-finite metrics at step %d (pre-save check) — divergence; keeping the "
                  "last good checkpoint and exiting 3", latest["step"])
        return False

    prof = None
    z_rng = torch.Generator(device=device).manual_seed(args.seed)
    taken = 0
    stop = diverged = capped = False
    try:
        for epoch in range(args.total_epoch):
            host = ({k: b[k] for k in keys} for b in map(prepare or (lambda b: b), loader))
            for batch in device_prefetch(host, device, size=2):
                for k in keys:
                    if k.startswith("labels"):
                        batch[k] = batch[k].long()
                if args.profile_dir and state.step == 10:
                    prof = _start_profiler(device)
                metrics = step_fn(batch, z_rng)
                taken += 1
                latest["metrics"], latest["step"] = metrics, state.step
                if prof is not None and state.step == 20:
                    _stop_profiler(prof, args.profile_dir, log)
                    prof = None
                if state.step % args.log_every == 0:
                    m = read_metrics(metrics, state.step)
                    if args.nan_guard and not finite(m):
                        diverged = stop = True
                        log.error("non-finite metrics at step %d: %s — divergence; keeping the "
                                  "last good checkpoint (skipping further saves) and exiting 3",
                                  state.step, {k: v for k, v in m.items() if not math.isfinite(v)})
                        break
                    log.info("epoch %d step %d: %s", epoch + 1, state.step,
                             {k: round(v, 4) for k, v in m.items()})
                    writer.write(state.step, m)
                    if fake_grid is not None and mesh.data_index == 0:  # its model group samples
                        writer.write_images(state.step, "fake", fake_grid(batch, state.step))
                    writer.write_images(state.step, "real", batch["images"][:16])
                if evaluator is not None and state.step % args.eval_every == 0:
                    em = evaluator(state)
                    mesh.barrier()  # no rank starts the next step while another evaluates
                    writer.write(state.step, em)
                    log.info("eval step %d: %s", state.step, {k: round(v, 4) for k, v in em.items()})
                if mesh.group is None or state.step % max(1, args.preempt_sync_every) == 0:
                    # every rank breaks on the OR of the flags, at the same step
                    stop = mesh.any(preempted["flag"])
                    if stop:
                        break
                if args.steps and taken >= args.steps:
                    capped = True
                    break
            if stop:
                if not diverged:
                    log.info("SIGTERM: saving checkpoint at step %d and exiting", state.step)
                break
            if capped:
                break
            if (epoch + 1) % args.save_every_epochs == 0:
                if not metrics_ok():
                    diverged = True
                    break
                ckpt.save(state)
                log.info("saved checkpoint at epoch %d (step %d)", epoch + 1, state.step)
        if not diverged:
            if metrics_ok():
                ckpt.save(state)
            else:
                diverged = True
        ckpt.wait()
    finally:
        if prof is not None:
            _stop_profiler(prof, args.profile_dir, log)
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return not diverged


# the LostGAN step's knobs, which the special families' steps have no path for
_SPECIAL_REFUSED = (("--ema_decay", "ema_decay", 0.0), ("--fused_d", "fused_d", False),
                    ("--remat", "remat", "none"), ("--remat_d_blocks", "remat_d_blocks", 0),
                    ("--torch_ckpt_g", "torch_ckpt_g", ""), ("--torch_ckpt_d", "torch_ckpt_d", ""),
                    ("--profile_dir", "profile_dir", ""))


def main_special(args, device: torch.device) -> None:
    """The Ours-ED and layout2im trainers (``layout2img_tpu/cli/train.py::main_special``).
    JAX trains them on a one-process mesh over the host's devices and
    refuses more processes; here that is ranks on one node."""
    from layout2img_tpu_torch.parallel.mesh import current, replicate
    from layout2img_tpu_torch.utils.logging import MetricWriter, close_logger, setup_logger

    mesh = current()
    if mesh.nodes > 1:
        raise SystemExit(f"--model {args.model} is a single-node trainer; launch it on one node "
                         "(its ranks on one host), not across nodes")
    model_parallel = args.model_parallel != 1

    if args.g_obj_budget or args.d_obj_budget:
        raise SystemExit(f"--g_obj_budget/--d_obj_budget are LostGAN-family flags; --model "
                         f"{args.model} has no object-budget path")
    given = [flag for flag, name, default in _SPECIAL_REFUSED if getattr(args, name) != default]
    if given:
        raise SystemExit(f"{', '.join(given)}: LostGAN-step flags; --model {args.model} has no "
                         "path for them")
    if args.img_size not in (0, 64):
        raise SystemExit(f"--model {args.model} is a 64px family; got --img_size {args.img_size}")
    args.img_size = 64
    num_classes, num_objects = dataset_spec(args.dataset)
    out_dir = os.path.join(args.out_path, args.dataset, str(args.img_size), args.model)
    log = setup_logger("layout2img_tpu_torch", out_dir, rank=mesh.rank)
    writer = MetricWriter(out_dir, rank=mesh.rank, tensorboard=args.tensorboard)
    if model_parallel:
        log.warning("--model_parallel %d (--mp_mode %s) changes nothing for --model %s: its "
                    "trainer runs data parallel over every rank (the JAX CLI ignores the flag "
                    "there too)", args.model_parallel, args.mp_mode, args.model)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        if args.model == "ours_ed":
            family = _ours_ed(args, num_classes, num_objects, device, log)
        else:
            family = _layout2im(args, num_classes, num_objects, device, log)
        state, step_fn, evaluator, loader, keys, prepare = family
        replicate(mesh, state)
        if not run_loop(args, state, step_fn, evaluator, loader, keys, out_dir, log, writer,
                        "f32", prepare=prepare):
            raise SystemExit(3)
        log.info("done: %d steps", state.step)
    finally:
        writer.close()
        close_logger(log)


def _ours_ed(args, num_classes: int, num_objects: int, device: torch.device, log):
    """Ours-ED's (state, step_fn, evaluator or None, loader, batch keys,
    batch preparation) for ``run_loop``."""
    from layout2img_tpu_torch.data.coco import split_fg_bg_batch
    from layout2img_tpu_torch.train.state import TrainConfig
    from layout2img_tpu_torch.train.step_bgfg import (STREAM_KEYS, create_bgfg_state,
                                                      make_bgfg_sample_fn, make_bgfg_train_step)
    from layout2img_tpu_torch.utils.convert import init_bgfg_generator, init_discriminator

    if args.mixed_precision:
        log.warning("--mixed_precision: the Ours-ED step runs in f32 (as the JAX package's, "
                    "which never reads the flag)")
    loader = build_dataset(args, num_objects, fg_bg=True)
    gen = init_bgfg_generator(args.seed, 91, num_classes - 91, device=device, ch=args.ch)
    disc = init_discriminator(args.seed + 1, num_classes, preset="d64", device=device, ch=args.ch)
    cfg = TrainConfig(g_lr=args.g_lr, d_lr=args.d_lr, use_vgg_loss=not args.no_vgg,
                      mixed_precision=args.mixed_precision)
    vgg = _vgg_loss(args, device, log) if cfg.use_vgg_loss else None
    state = create_bgfg_state(gen, disc, cfg)
    evaluator = (build_evaluator(args, make_bgfg_sample_fn(gen), loader, device, log,
                                 prepare=split_fg_bg_batch) if args.eval_every > 0 else None)
    return (state, make_bgfg_train_step(state, cfg, vgg_loss=vgg), evaluator, loader,
            ("images", "labels", "boxes", *STREAM_KEYS), split_fg_bg_batch)


def _layout2im(args, num_classes: int, num_objects: int, device: torch.device, log):
    """layout2im's (state, step_fn, evaluator or None, loader, batch keys,
    batch preparation) for ``run_loop``."""
    from layout2img_tpu_torch.train.step_layout2im import (Layout2ImConfig,
                                                           create_layout2im_state,
                                                           make_layout2im_sample_fn,
                                                           make_layout2im_train_step)
    from layout2img_tpu_torch.utils.convert import (init_layout2im_discriminators,
                                                    init_layout2im_generator)

    loader = build_dataset(args, num_objects)
    gen = init_layout2im_generator(args.seed, num_classes, fusion=args.l2i_fusion, device=device)
    d_img, d_obj = init_layout2im_discriminators(args.seed + 1, num_classes, conv_dim=args.ch,
                                                 device=device)
    cfg = Layout2ImConfig(lr_g=args.g_lr, lr_d=args.d_lr)
    state = create_layout2im_state(gen, d_img, d_obj, cfg)
    evaluator = (build_evaluator(args, make_layout2im_sample_fn(gen), loader, device, log,
                                 prepare=lambda b: b) if args.eval_every > 0 else None)
    return (state, make_layout2im_train_step(state, cfg), evaluator, loader,
            ("images", "labels", "boxes"), None)


def build_evaluator(args, sample_fn, loader, device: torch.device, log: logging.Logger,
                    prepare=None):
    """The ``--eval_every`` hook on a frozen pool of the loader's first
    ``ceil(eval_n / batch_size)`` batches (a loader's pass counts as an
    epoch, as in the JAX CLI): each rank's own, so the pool is W times that. With ``prepare`` (the special families) the
    pool is the prepared batches and ``sample_fn(batch, rng)`` takes whole
    batches (``PeriodicEval(batch_mode=True)``)."""
    from layout2img_tpu_torch.parallel.mesh import DataMesh, current, use
    from layout2img_tpu_torch.train.eval_hook import PeriodicEval

    batches = iter(loader)
    pool = list(itertools.islice(batches, max(1, -(-args.eval_n // args.batch_size))))
    batches.close()
    if prepare is not None:
        pool = [prepare(b) for b in pool]
        batch_fn = sample_fn

        def sample_fn(params, batch, rng):  # no EMA here
            with use(DataMesh()):  # each rank's own pool and seed: latents drawn for it alone
                return batch_fn(batch, rng)
    evaluator = PeriodicEval(sample_fn, pool, inception_weights=args.inception_weights,
                             device=device, seed=args.seed, batch_mode=prepare is not None,
                             mesh=current().data_view())
    if not evaluator.real_weights:
        log.warning("--eval_every without --inception_weights: rel_fid uses fixed-seed random "
                    "filters (relative trajectory only)")
    log.info("periodic eval: %d real images every %d steps", evaluator.n_images, args.eval_every)
    return evaluator


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, log: logging.Logger) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


if __name__ == "__main__":
    main()
