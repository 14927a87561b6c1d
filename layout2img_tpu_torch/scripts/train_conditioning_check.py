"""Semantic end-to-end check: does the conditioning path learn? (The port's
counterpart of the JAX repo's ``scripts/train_conditioning_check.py``, with
its flags, defaults, task, scores and gate.)

Synthetic task: each class is a fixed color; images are class-colored
rectangles at their boxes on a gray background. A correctly-wired
generator (label embedding -> context -> ISLA modulation inside mask
footprints) must learn to paint the right color inside the right box.

Metrics:
- mean cosine similarity between generated and target colors inside valid
  boxes, before vs after training;
- optionally (--fid) a RELATIVE FID trajectory using the fixed-seed
  random-filter InceptionV3 (absolute values are not comparable to the
  literature, but the downward trend over training is a valid signal).

    python -m layout2img_tpu_torch.scripts.train_conditioning_check        # flagship, COCO-ish
    python -m layout2img_tpu_torch.scripts.train_conditioning_check --preset graph128 --no_app_head
    python -m layout2img_tpu_torch.scripts.train_conditioning_check --preset context128_part --no_app_head
    python -m layout2img_tpu_torch.scripts.train_conditioning_check --num_classes 179 --objects 31
    python -m layout2img_tpu_torch.scripts.train_conditioning_check --preset ours_ed
    python -m layout2img_tpu_torch.scripts.train_conditioning_check --preset layout2im

The LostGAN presets train through ``train/step.py`` with mixed precision and
no VGG loss; ``ours_ed`` through ``train/step_bgfg.py`` (its task adds a
class-colored background wall under the fg boxes; the fg score gates, the bg
and the wall-projected ``fg_orth`` scores are tracked); ``layout2im``
through ``train/step_layout2im.py``, scored on the ``img_rand`` pathway
(labels and boxes with prior z). Each chunk is 50 steps of a Python loop
on one of 8 batches that stay on the device; latents come from a ``torch.Generator`` seeded per chunk, not
from ``jax.random``.

Initial weights: where ``conditioning_init.json`` has a table for the
configuration (the flagship at these defaults, ``graph128`` and
``context128_part`` with ``--no_app_head``), G and D start from the JAX
script's own (``PRNGKey(0)``), redrawn in numpy (``utils/jax_random.py``).
Elsewhere they are seeded torch draws of the same initializers (G from seed
0; D from seed 1, the special families' Ds from 0). Runs on the GPU; ``--device cpu`` asks for the
CPU. ``--torch_init`` (the reference's torch models from a checkout of the
original code, which is not in the repository) is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from layout2img_tpu_torch.device import resolve_device

PAD_BOX = (-0.6, -0.6, 0.5, 0.5)
N_BG_CLASSES = 4  # background wall-colors for the ours_ed task (ids 1..4)
STEPS_PER_CHUNK = 50
_TORCH_INIT = ("--torch_init builds the reference's torch models from a checkout of the original "
               "code, which is not in the repository: it waits for those files (ROADMAP.md §1, "
               "item 8)")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="ours_d_context128",
                   help="a make_generator preset, or the special families "
                        "'ours_ed' / 'layout2im'")
    p.add_argument("--num_classes", type=int, default=12)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--ch", type=int, default=24)
    p.add_argument("--chunks", type=int, default=int(os.environ.get("COND_CHUNKS", "16")),
                   help="training chunks of 50 steps each")
    p.add_argument("--no_app_head", action="store_true")
    p.add_argument("--fid", action="store_true",
                   help="track relative FID (fixed-seed random inception)")
    p.add_argument("--image_out", default="build/conditioning_target_vs_generated.png")
    p.add_argument("--min_score", type=float, default=0.5)
    p.add_argument("--g_obj_budget", type=int, default=0,
                   help="compact-and-truncate the object axis for G+D "
                        "(exact when >= valid count; v2-trunk presets only)")
    p.add_argument("--d_obj_budget", type=int, default=0, help="D-only object budget (any preset)")
    p.add_argument("--remat_d_blocks", type=int, default=0,
                   help="checkpoint the first N D ResBlocks (needed to fit "
                        "256px runs at useful batch sizes)")
    p.add_argument("--neutral_bg", action="store_true",
                   help="ours_ed control experiment: replace the saturated class-colored "
                        "background walls with the LostGAN task's neutral gray, keeping the "
                        "trainer and model identical")
    p.add_argument("--torch_init", action="store_true", help=f"refused: {_TORCH_INIT}")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def make_palette(num_classes):
    return np.stack(
        [np.zeros(3)]
        + [np.array([((c * 37) % 11) / 10, ((c * 53) % 7) / 6, ((c * 71) % 5) / 4]) * 2 - 1
           for c in range(1, num_classes)]
    )


def make_batch(rng, a, palette):
    """{"images" (b, s, s, 3) NHWC f32, "labels" (b, o) int32, "boxes" (b, o, 4)
    f32}, numpy."""
    b, o, s = a.batch_size, a.objects, a.img_size
    labels = np.zeros((b, o), np.int32)
    boxes = np.tile(np.asarray(PAD_BOX, np.float32), (b, o, 1))
    images = np.full((b, s, s, 3), -0.2, np.float32)  # gray bg
    for i in range(b):
        n = int(rng.integers(2, min(o, 6) + 1))
        for j in range(n):
            labels[i, j] = int(rng.integers(1, a.num_classes))
            x0, y0 = rng.uniform(0, 0.55, 2)
            w, h = rng.uniform(0.25, 0.4, 2)
            boxes[i, j] = (x0, y0, w, h)
            px = (np.array([x0, y0, x0 + w, y0 + h]) * s).astype(int).clip(0, s)
            images[i, px[1]:px[3], px[0]:px[2]] = palette[labels[i, j]]
    return {"images": images, "labels": labels, "boxes": boxes}


def make_batch_bgfg(rng, a, palette):
    """fg/bg task: a class-colored BACKGROUND (one of N_BG_CLASSES wall
    colors, bg-stream label) under class-colored fg boxes, with the split
    keys ``train/step_bgfg.py`` expects (mirroring ``data.coco.split_fg_bg``:
    fg ids 1..num_classes-1 keep their id; bg stream id j maps to combined D
    id num_classes-1+j). Numpy."""
    b, o, s = a.batch_size, a.objects, a.img_size
    pad = np.asarray(PAD_BOX, np.float32)
    out = {k: np.zeros((b, o), np.int32) for k in ("labels", "labels_fg", "labels_bg")}
    out |= {k: np.tile(pad, (b, o, 1)) for k in ("boxes", "boxes_fg", "boxes_bg")}
    images = np.empty((b, s, s, 3), np.float32)
    for i in range(b):
        j_bg = int(rng.integers(1, N_BG_CLASSES + 1))
        images[i] = palette[a.num_classes - 1 + j_bg]
        out["labels_bg"][i, 0] = j_bg
        out["boxes_bg"][i, 0] = (0.0, 0.0, 1.0, 1.0)
        out["labels"][i, o - 1] = a.num_classes - 1 + j_bg
        out["boxes"][i, o - 1] = (0.0, 0.0, 1.0, 1.0)
        n = int(rng.integers(1, min(o - 1, 5) + 1))
        for j in range(n):
            lab = int(rng.integers(1, a.num_classes))
            x0, y0 = rng.uniform(0, 0.55, 2)
            w, h = rng.uniform(0.25, 0.4, 2)
            out["labels_fg"][i, j] = lab
            out["boxes_fg"][i, j] = (x0, y0, w, h)
            out["labels"][i, j] = lab
            out["boxes"][i, j] = (x0, y0, w, h)
            px = (np.array([x0, y0, x0 + w, y0 + h]) * s).astype(int).clip(0, s)
            images[i, px[1]:px[3], px[0]:px[2]] = palette[lab]
    return {"images": images} | out


def color_score(imgs, labels, boxes, s, palette):
    """Mean cosine similarity between box-interior mean color and the class color."""
    imgs = np.asarray(imgs)
    scores = []
    for i in range(imgs.shape[0]):
        for j in range(labels.shape[1]):
            if labels[i, j] == 0:
                continue
            x0, y0, w, h = np.asarray(boxes[i, j])
            px = (np.array([x0 + 0.25 * w, y0 + 0.25 * h, x0 + 0.75 * w, y0 + 0.75 * h]) * s).astype(int)
            region = imgs[i, px[1]:px[3], px[0]:px[2]]
            if region.size == 0:
                continue
            got = region.reshape(-1, 3).mean(0)
            want = palette[labels[i, j]]
            scores.append(
                float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-6))
            )
    return float(np.mean(scores))


def bg_color_score(imgs, batch, s, palette, num_classes):
    """ours_ed: cosine between the mean color OUTSIDE every fg box and the
    target background wall color (the bg-stream conditioning signal)."""
    imgs = np.asarray(imgs)
    labels_fg = np.asarray(batch["labels_fg"])
    boxes_fg = np.asarray(batch["boxes_fg"])
    labels_bg = np.asarray(batch["labels_bg"])
    scores = []
    for i in range(imgs.shape[0]):
        mask = np.ones((s, s), bool)
        for j in range(labels_fg.shape[1]):
            if labels_fg[i, j] == 0:
                continue
            x0, y0, w, h = boxes_fg[i, j]
            px = (np.array([x0, y0, x0 + w, y0 + h]) * s).astype(int).clip(0, s)
            mask[px[1]:px[3], px[0]:px[2]] = False
        if not mask.any():
            continue
        got = imgs[i][mask].mean(0)
        want = palette[num_classes - 1 + labels_bg[i, 0]]
        scores.append(
            float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-6))
        )
    return float(np.mean(scores))


def fg_orth_score(imgs, batch, s, palette, num_classes):
    """ours_ed bleed-immune fg metric: the two-stream composite is a LEARNED
    feature fusion, so box-interior pixels mix the fg class color with the
    saturated bg wall color, depressing the plain cosine even when the fg
    signal is fully present. Project the wall-color direction out of BOTH
    the measured and target colors and take the cosine of the residuals: any
    additive wall-color mixing drops out, leaving only the fg-class
    component."""
    imgs = np.asarray(imgs)
    labels_fg = np.asarray(batch["labels_fg"])
    boxes_fg = np.asarray(batch["boxes_fg"])
    labels_bg = np.asarray(batch["labels_bg"])
    scores = []
    for i in range(imgs.shape[0]):
        wall = palette[num_classes - 1 + labels_bg[i, 0]]
        nb = np.linalg.norm(wall)
        if nb < 1e-6:
            continue  # neutral-gray control: nothing to project out
        bhat = wall / nb
        for j in range(labels_fg.shape[1]):
            if labels_fg[i, j] == 0:
                continue
            x0, y0, w, h = np.asarray(boxes_fg[i, j])
            px = (np.array([x0 + 0.25 * w, y0 + 0.25 * h,
                            x0 + 0.75 * w, y0 + 0.75 * h]) * s).astype(int)
            region = imgs[i, px[1]:px[3], px[0]:px[2]]
            if region.size == 0:
                continue
            got = region.reshape(-1, 3).mean(0)
            want = palette[labels_fg[i, j]]
            got_p = got - (got @ bhat) * bhat
            want_p = want - (want @ bhat) * bhat
            if np.linalg.norm(want_p) < 0.2:
                continue  # fg color ~parallel to the wall: no residual signal
            scores.append(float(
                got_p @ want_p
                / (np.linalg.norm(got_p) * np.linalg.norm(want_p) + 1e-6)))
    return float(np.mean(scores)) if scores else float("nan")


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch on ``device``: images NCHW f32, labels int64, boxes f32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if k == "images":
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t.long() if k.startswith("labels") else t.float()
    return out


def nhwc(images: torch.Tensor) -> np.ndarray:
    return images.float().permute(0, 2, 3, 1).cpu().numpy()


INIT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conditioning_init.json")


def init_config(a) -> dict:
    """What the JAX script's LostGAN initial weights depend on."""
    return {"preset": a.preset, "num_classes": a.num_classes, "ch": a.ch, "img_size": a.img_size,
            "app_head": not a.no_app_head, "remat_d_blocks": a.remat_d_blocks}


def jax_initial_networks(a, device):
    """The JAX script's own initial G and D (``create_train_state(
    jax.random.PRNGKey(0), ...)``), redrawn in numpy from ``INIT_TABLE``
    (each variable's shape, initializer and key path, recorded by
    ``tests/test_torch_port_conditioning_init.py`` for the flagship at the
    script's defaults and for ``graph128`` and ``context128_part`` with
    ``--no_app_head``, the LostGAN rows of the JAX README's table) and
    converted to the port's layout; None for a configuration without a
    table."""
    from layout2img_tpu_torch.models.discriminators import make_discriminator
    from layout2img_tpu_torch.models.generators import make_generator
    from layout2img_tpu_torch.utils import jax_random
    from layout2img_tpu_torch.utils.convert import (discriminator_state_dict_from_jax,
                                                    generator_state_dict_from_jax)

    with open(INIT_TABLE) as f:
        table = next((t for t in json.load(f) if t["config"] == init_config(a)), None)
    if table is None:
        return None
    roots = dict(zip(("generator", "discriminator"),  # create_train_state's rng_g, rng_d
                     jax_random.split(jax_random.prng_key(0), 3)))
    trees = {}
    for net, root in roots.items():
        tree = trees[net] = {}
        for col, path, shape, kind, suffix in table[net]:
            node = tree.setdefault(col, {})
            for name in path[:-1]:
                node = node.setdefault(name, {})
            key = jax_random.fold_in_path(root, tuple(suffix)) if suffix else None
            node[path[-1]] = jax_random.initializer(kind, key, shape)
    gen = make_generator(a.preset, a.num_classes, device="cpu", ch=a.ch, image_size=a.img_size,
                         num_mask_classes=a.num_classes)
    gen.load_state_dict(generator_state_dict_from_jax(trees["generator"], res_start=gen.res_start),
                        strict=True)
    disc = make_discriminator("d128_app", a.num_classes, device="cpu", ch=a.ch,
                              image_size=a.img_size, app_head=not a.no_app_head,
                              remat_blocks=a.remat_d_blocks)
    disc.load_state_dict(discriminator_state_dict_from_jax(trees["discriminator"]), strict=True)
    return gen.to(device), disc.to(device)


def torch_initial_networks(a, device, seed: int = 0):
    """G and D of a LostGAN configuration from seeded torch draws of the
    JAX package's initializers (``utils/convert.py``): G from ``seed``, D
    from ``seed + 1``."""
    from layout2img_tpu_torch.utils import convert

    return (convert.init_generator(seed, a.num_classes, preset=a.preset, device=device, ch=a.ch,
                                   image_size=a.img_size, num_mask_classes=a.num_classes),
            convert.init_discriminator(seed + 1, a.num_classes, device=device,
                                       image_size=a.img_size,
                                       ch=a.ch, app_head=not a.no_app_head,
                                       remat_blocks=a.remat_d_blocks))


def build_family(a, device: torch.device):
    """(state, step, batch_fn, score_fn, pixel_key, palette) for the requested
    preset: the LostGAN family through the generic GAN step, or one of the
    special-family trainers. ``score_fn(batch, rng)`` gives (score, extra
    scores, NHWC images) for a numpy batch."""
    from layout2img_tpu_torch.train.state import TrainConfig
    from layout2img_tpu_torch.utils import convert

    if a.preset == "ours_ed":
        from layout2img_tpu_torch.train.step_bgfg import (create_bgfg_state, make_bgfg_sample_fn,
                                                          make_bgfg_train_step)

        if a.img_size != 64:
            raise SystemExit("ours_ed is the 64px family")
        palette = make_palette(a.num_classes + N_BG_CLASSES)
        if a.neutral_bg:
            # control: every wall becomes the LostGAN task's neutral gray --
            # same trainer and model, the fg measurement now matches the LostGAN task
            palette[a.num_classes:] = -0.2
        gen = convert.init_bgfg_generator(0, a.num_classes, N_BG_CLASSES + 1,
                                          device=device, ch=a.ch)
        disc = convert.init_discriminator(0, a.num_classes + N_BG_CLASSES,
                                          preset="d64", device=device, ch=a.ch)
        cfg = TrainConfig(use_vgg_loss=False)
        state = create_bgfg_state(gen, disc, cfg)
        sample = make_bgfg_sample_fn(gen)

        def score_fn(batch, rng):
            img = nhwc(sample(batch, rng))
            fg = color_score(img, batch["labels_fg"], batch["boxes_fg"], a.img_size, palette)
            bg = bg_color_score(img, batch, a.img_size, palette, a.num_classes)
            orth = fg_orth_score(img, batch, a.img_size, palette, a.num_classes)
            return fg, {"bg": bg, "fg_orth": orth}, img

        return (state, make_bgfg_train_step(state, cfg), lambda rng: make_batch_bgfg(rng, a, palette),
                score_fn, "pixel_loss", palette)

    if a.preset == "layout2im":
        from layout2img_tpu_torch.ops.bbox import bbox_mask
        from layout2img_tpu_torch.train.step_layout2im import (Layout2ImConfig,
                                                               create_layout2im_state,
                                                               make_layout2im_train_step)

        if a.img_size != 64:
            raise SystemExit("layout2im is the 64px family")
        palette = make_palette(a.num_classes)
        gen = convert.init_layout2im_generator(0, a.num_classes, device=device)
        d_img, d_obj = convert.init_layout2im_discriminators(0, a.num_classes,
                                                             conv_dim=a.ch, device=device)
        cfg = Layout2ImConfig()
        state = create_layout2im_state(gen, d_img, d_obj, cfg)

        @torch.no_grad()
        def score_fn(batch, rng):
            # the img_rand pathway: labels and boxes only, prior z -- the
            # purest conditioning probe this family has
            t = to_device({k: batch[k] for k in ("labels", "boxes")}, device)
            z = torch.randn((*t["labels"].shape, gen.z_dim), generator=rng, device=rng.device)
            gen.eval()
            img = nhwc(gen.sample(t["labels"], t["boxes"], bbox_mask(t["boxes"], 64, 64),
                                  z.to(device)))
            s = color_score(img, batch["labels"], batch["boxes"], a.img_size, palette)
            return s, {}, img

        return (state, make_layout2im_train_step(state, cfg), lambda rng: make_batch(rng, a, palette),
                score_fn, "img_rec_l1", palette)

    # ---- LostGAN family via the generic GAN step ----
    from layout2img_tpu_torch.models.generators import obj_budget_error
    from layout2img_tpu_torch.sample import make_sample_fn
    from layout2img_tpu_torch.train.state import create_train_state
    from layout2img_tpu_torch.train.step import make_train_step

    nets = jax_initial_networks(a, device)
    if nets is None:  # seeded torch draws of the same initializers, G and D independent
        nets = torch_initial_networks(a, device)
        print("initial weights: seeded torch draws (no JAX table for this configuration)")
    else:
        print("initial weights: the JAX script's own (PRNGKey(0), redrawn in numpy)")
    gen, disc = nets
    palette = make_palette(a.num_classes)
    if a.g_obj_budget:
        why = obj_budget_error(gen)
        if why is not None:
            raise SystemExit(f"--g_obj_budget is not exact for this preset: {why}")
    cfg = TrainConfig(use_vgg_loss=False, mixed_precision=True,
                      g_obj_budget=a.g_obj_budget, d_obj_budget=a.d_obj_budget)
    state = create_train_state(gen, disc, cfg)
    sample = make_sample_fn(gen, z_dim=cfg.z_dim)

    def score_fn(batch, rng):
        gen.eval()  # running BN statistics; the train step sets training mode itself
        img = nhwc(sample(torch.from_numpy(batch["boxes"]), torch.from_numpy(batch["labels"]), rng))
        s = color_score(img, batch["labels"], batch["boxes"], a.img_size, palette)
        return s, {}, img

    return (state, make_train_step(state, cfg), lambda rng: make_batch(rng, a, palette), score_fn,
            "pixel_loss", palette)


def _isla_counts() -> tuple[int, int, int]:
    from layout2img_tpu_torch.ops.isla import isla_norm, isla_norm_backward

    return isla_norm.launches, isla_norm_backward.launches, isla_norm_backward.finish_launches


def run_check(a) -> dict:
    """Train and score as ``main`` does, without the gate; returns what it
    printed as numbers: the scores before and after, the trajectory every 4
    chunks, the training seconds, and the ISLA kernels' launches per
    training step (forward, backward main, backward finishing; 0 on the
    CPU)."""
    if a.torch_init:
        raise SystemExit(_TORCH_INIT)
    device = resolve_device(a.device)
    # f32 as the JAX package's f32: no TF32 in cuDNN or matmul (as cli.train runs)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    state, step, batch_fn, score_fn, pixel_key, palette = build_family(a, device)
    rng_np = np.random.default_rng(0)
    batches = [batch_fn(rng_np) for _ in range(8)]
    eval_batches = [batch_fn(rng_np) for _ in range(4)]
    eval_batch = eval_batches[0]
    resident = [to_device(b, device) for b in batches]

    def rng(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    fid_fn = None
    if a.fid:
        from layout2img_tpu_torch.eval.inception import load_inception
        from layout2img_tpu_torch.eval.metrics import fid_from_features, run_inception_batches

        net = load_inception("", device)
        real_feats, _ = run_inception_batches(net, (b["images"] for b in eval_batches))

        def fid_fn():
            fakes = (score_fn(b, rng(70 + i))[2] for i, b in enumerate(eval_batches))
            feats, _ = run_inception_batches(net, fakes)
            return fid_from_features(feats, real_feats)

    def score():
        s, extra, _ = score_fn(eval_batch, rng(7))
        return s, extra

    s0, extra0 = score()
    fid0 = fid_fn() if fid_fn else None
    print(f"[{a.preset} c={a.num_classes} o={a.objects}] "
          f"color score before training: {s0:+.3f}"
          + "".join(f"  {k} {v:+.3f}" for k, v in extra0.items())
          + (f"  rel-FID {fid0:8.2f}" if fid0 is not None else ""), flush=True)

    t0 = time.perf_counter()
    train_s = 0.0
    launches = [0, 0, 0]
    trajectory = []
    pixel_trace: list[float] = []
    for i in range(a.chunks):
        t_chunk = time.perf_counter()
        before = _isla_counts()
        chunk_rng = rng(100 + i)
        d_l, p_l = [], []
        for _ in range(STEPS_PER_CHUNK):
            m = step(resident[i % len(resident)], chunk_rng)
            d_l.append(m["d_loss"])
            p_l.append(m[pixel_key])
        d_last, p_last, p_mean = (float(v) for v in (d_l[-1], p_l[-1], torch.stack(p_l).mean()))
        launches = [n + c - b for n, c, b in zip(launches, _isla_counts(), before)]
        train_s += time.perf_counter() - t_chunk
        pixel_trace.append(p_mean)
        assert np.isfinite(p_mean) and np.isfinite(d_last), f"training diverged at chunk {i}"
        if (i + 1) % 4 == 0:
            s, extra = score()
            fid = fid_fn() if fid_fn else None
            trajectory.append({"step": (i + 1) * STEPS_PER_CHUNK, "d_loss": d_last,
                               pixel_key: p_last, "score": s, **extra,
                               **({"rel_fid": fid} if fid is not None else {})})
            print(f"steps {(i + 1) * STEPS_PER_CHUNK:4d}: d_loss {d_last:6.3f} "
                  f"{pixel_key} {p_last:5.3f} color-score {s:+.3f} "
                  + "".join(f"{k} {v:+.3f} " for k, v in extra.items())
                  + (f"rel-FID {fid:8.2f} " if fid is not None else "")
                  + f"({time.perf_counter() - t0:5.1f}s)", flush=True)
    s1, extra1 = score()
    print(f"\ncolor-conditioning score: {s0:+.3f} -> {s1:+.3f}"
          + "".join(f"  {k} {extra0[k]:+.3f} -> {v:+.3f}" for k, v in extra1.items()))
    steps = a.chunks * STEPS_PER_CHUNK
    per_step = [n / max(steps, 1) for n in launches]
    print(f"{steps} steps in {train_s:.1f}s of training ({time.perf_counter() - t0:.1f}s with "
          f"the scoring); ISLA launches per step: forward {per_step[0]:g}, backward "
          f"{per_step[1]:g} + {per_step[2]:g} finishing")

    if a.image_out:
        # visual artifact: target layouts vs generated
        import PIL.Image

        from layout2img_tpu_torch.cli.visualize import draw_boxes

        os.makedirs(os.path.dirname(a.image_out) or ".", exist_ok=True)
        _, _, img_after = score_fn(eval_batch, rng(7))
        rows = []
        tgt = eval_batch["images"]
        for k in range(min(6, tgt.shape[0])):
            rows.append(np.concatenate([
                draw_boxes(tgt[k], eval_batch["boxes"][k], eval_batch["labels"][k]),
                np.clip(img_after[k] * 0.5 + 0.5, 0, 1),
            ], axis=1))
        grid = np.concatenate(rows, axis=0)
        PIL.Image.fromarray((grid * 255).astype(np.uint8)).save(a.image_out)
        print(f"wrote {a.image_out}")
    return {"preset": a.preset, "score_before": s0, "score_after": s1, "extra_before": extra0,
            "extra_after": extra1, "trajectory": trajectory, "steps": steps,
            "train_seconds": train_s, "isla_launches_per_step": per_step}


def learned(result: dict, min_score: float) -> bool:
    """The JAX script's gate: the score after training passes ``min_score``
    and rose by more than 0.3."""
    s0, s1 = result["score_before"], result["score_after"]
    return s1 > min_score and s1 > s0 + 0.3


def main(argv=None) -> dict:
    a = parse_args(argv)
    result = run_check(a)
    if not learned(result, a.min_score):
        raise SystemExit(f"conditioning did not learn: {result['score_before']:+.3f} -> "
                         f"{result['score_after']:+.3f} (the gate: above {a.min_score} and "
                         "0.3 above the start)")
    print("CONDITIONING OK")
    return result


if __name__ == "__main__":
    main()
