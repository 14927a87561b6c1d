"""Component-level timing of the mixed-precision train step on the card (the
port's counterpart of the JAX repo's ``scripts/profile_step.py``): G forward
(eval), D forward, VGG loss forward, the full step without VGG and with it;
and, with ``--roi_detail``, what computing BOTH scale crops for every object
(``ops/roi.py::dual_scale_roi_align``, a static-shape design choice) costs as
a share of the D forward, against the two one-scale ``roi_align`` calls at
D's feature shapes.

    python -m layout2img_tpu_torch.scripts.profile_step                     # flagship, COCO shape
    python -m layout2img_tpu_torch.scripts.profile_step --preset graph128   # GCN-context variant
    python -m layout2img_tpu_torch.scripts.profile_step --objects 31 --num_classes 179 --roi_detail

The flags and defaults are the JAX script's. Every component runs at the
dtypes of the port's mixed step (``TrainConfig(mixed_precision=True)``): G,
D and VGG on bf16 casts of their f32 weights (``utils/casting.py::
cast_params``), bf16 latents and images. G and D are the port's seeded
networks (``ours_d_context128`` style preset, ``d128_app``), VGG19 has
seeded filters, and the batch is one synthetic batch from
``numpy.random.default_rng(0)``. Each component is called once to warm up,
then ``--k`` (50) times on fresh noise, timed by CUDA events; the line gives
ms per call and img/s. It prints the card's ``nvidia-smi`` name and power
limit first. It runs on the card; ``--device cpu`` (timed by the host's
clock) and ``--ch`` are for tests at a small width.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from layout2img_tpu_torch.bench import card_line
from layout2img_tpu_torch.device import resolve_device
from layout2img_tpu_torch.scripts.bench_inference import ms_per_call


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="ours_d_context128")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--objects", type=int, default=8)
    p.add_argument("--num_classes", type=int, default=184)
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--roi_detail", action="store_true",
                   help="micro-time dual_scale_roi_align vs one-scale roi_align at the D's "
                        "actual feature shapes")
    p.add_argument("--k", type=int, default=50, help="timed calls per component")
    p.add_argument("--ch", type=int, default=64, help="channel width of G and D")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def timed(name: str, fn, k: int, batch_size: int, device: torch.device) -> float:
    """ms per call of ``fn()`` over k calls after one that warms up; prints
    the JAX script's line."""
    fn()
    ms = ms_per_call(fn, k, device)
    print(f"{name:34s} {ms:8.2f} ms/step  ({batch_size / (ms / 1000.0):7.1f} img/s)", flush=True)
    return ms


def main(argv=None) -> dict[str, float]:
    """Time every component; returns {component name: ms per call}."""
    from layout2img_tpu_torch.data.synthetic import synthetic_batch
    from layout2img_tpu_torch.losses.perceptual import VGGLoss
    from layout2img_tpu_torch.ops.bbox import xywh_to_xyxy
    from layout2img_tpu_torch.ops.roi import dual_scale_roi_align, roi_align
    from layout2img_tpu_torch.train.state import TrainConfig, create_train_state
    from layout2img_tpu_torch.train.step import make_train_step
    from layout2img_tpu_torch.utils.casting import cast_params
    from layout2img_tpu_torch.utils.convert import init_discriminator, init_generator, init_vgg

    a = parse_args(argv)
    device = resolve_device(a.device)
    B, O, S, NC = a.batch_size, a.objects, a.img_size, a.num_classes
    bf16 = torch.bfloat16
    if device.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    gen = init_generator(0, NC, preset=a.preset, device=device, ch=a.ch, image_size=S)
    disc = init_discriminator(1, NC, preset="d128_app", device=device, ch=a.ch, image_size=S)
    vgg = VGGLoss(init_vgg(2, device=device))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in synthetic_batch(np.random.default_rng(0), B, S, O, NC).items()}
    batch["labels"] = batch["labels"].long()
    print(f"[{a.preset} b={B} o={O} nc={NC} s={S}]", flush=True)
    imgs = batch["images"].to(bf16)
    g = torch.Generator(device=device).manual_seed(0)

    def noise(shape, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=g, device=device, dtype=bf16) * scale

    ms = {}
    g_params = cast_params(gen, bf16)
    z_im = torch.zeros((B, gen.z_dim), dtype=bf16, device=device)

    @torch.no_grad()
    def g_fwd():
        gen.eval()
        return torch.func.functional_call(
            gen, g_params, (noise((B, O, gen.z_dim)), batch["boxes"], batch["labels"], z_im))

    ms["G forward (eval)"] = timed("G forward (eval)", g_fwd, a.k, B, device)

    d_params = cast_params(disc, bf16)

    @torch.no_grad()
    def d_fwd():
        disc.eval()  # no power-iteration update (the JAX script's update_stats=False)
        out = torch.func.functional_call(
            disc, d_params, (imgs + noise(imgs.shape, 0.01), batch["boxes"], batch["labels"]))
        return out["image"], out["object"], out.get("app")

    ms["D forward"] = timed("D forward", d_fwd, a.k, B, device)

    if a.roi_detail:
        # dual_scale_roi_align computes BOTH scale crops per object and selects
        # (static shapes; the reference routes data-dependently): the second
        # crop's cost at D's true feature shapes
        c = a.ch * 8
        if S == 128:
            sc_s, sc_l, thr = 1 / 4, 1 / 8, 64.0
        else:
            sc_s, sc_l, thr = 1 / 8, 1 / 16, 128.0
        fs = torch.zeros((B, c, 32, 32), dtype=bf16, device=device)
        fl = torch.zeros((B, c, 16, 16), dtype=bf16, device=device)
        boxes_px = xywh_to_xyxy(batch["boxes"]) * S

        def dual():
            n = noise(fs.shape, 0.01)
            return dual_scale_roi_align(fs + n, fl + n[..., :16, :16], boxes_px, 8, sc_s, sc_l,
                                        thr)

        def single_small():
            return roi_align(fs + noise(fs.shape, 0.01), boxes_px, 8, sc_s)

        def single_large():
            return roi_align(fl + noise(fs.shape, 0.01)[..., :16, :16], boxes_px, 8, sc_l)

        dt_dual = timed("RoI dual-scale (both crops)", dual, a.k, B, device)
        dt_s = timed("RoI small-scale only", single_small, a.k, B, device)
        dt_l = timed("RoI large-scale only", single_large, a.k, B, device)
        ms.update({"RoI dual-scale (both crops)": dt_dual, "RoI small-scale only": dt_s,
                   "RoI large-scale only": dt_l})
        waste = min(dt_s, dt_l)
        print(f"{'':2s}compute-both overhead ~{waste:.2f} ms "
              f"= {100 * waste / ms['D forward']:.1f}% of the D forward "
              f"(o={O}; the cheaper crop is the upper bound on the waste)", flush=True)

    @torch.no_grad()
    def vgg_fwd():
        return vgg(imgs + noise(imgs.shape, 0.01), imgs, dtype=bf16)

    ms["VGG loss forward"] = timed("VGG loss forward", vgg_fwd, a.k, B, device)

    for name, use_vgg in (("full step (no VGG)", False), ("full step (VGG)", True)):
        cfg = TrainConfig(mixed_precision=True, use_vgg_loss=use_vgg)
        state = create_train_state(gen, disc, cfg)
        step = make_train_step(state, cfg, vgg_loss=vgg if use_vgg else None)
        rng = torch.Generator(device=device).manual_seed(1)  # fresh latents every step
        ms[name] = timed(name, lambda: step(batch, rng), a.k, B, device)
    return ms


if __name__ == "__main__":
    main()
