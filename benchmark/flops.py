"""Work counted once from the reference at a cell's shapes, on meta tensors
(no memory, no device): FLOPs by ``torch.utils.flop_counter.FlopCounterMode``
and the shapes of every ISLA norm call.

A train step counts G's forward and backward, D's three forwards (real,
detached fake, fake for the G loss) and the backwards the step takes (D
from the D loss, D and G from the G loss), and, where the configuration
has the VGG loss, VGG19 on the fake and the real images with its backward
on the fake. Nothing is recomputed in the
step, so nothing is counted twice. A sample batch counts G's forward.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets
from benchmark.reference import step as ref


def _inputs(config: dict, images: bool) -> dict:
    b, o, s = config["batch"], config["slots"], config["image_size"]
    out = {"boxes": torch.empty(b, o, 4), "labels": torch.ones(b, o, dtype=torch.long),
           "z": torch.empty(b, o, config["z_dim"]), "z_im": torch.empty(b, config["z_dim"])}
    if images:
        out["images"] = torch.empty(b, 3, s, s)
    return out


def _record(gen: torch.nn.Module) -> list:
    calls: list = []
    for m in gen.modules():
        if isinstance(m, nets.ISLANorm):
            m.calls = calls
    return calls


def train_work(config: dict) -> tuple[float, list]:
    """(FLOPs of one train step, [(x shape, mask shape)] of its forward
    ISLA calls: each has one backward call too)."""
    with torch.device("meta"):
        n = ref.build(config, "meta")
        gen = n["G"]
        step = ref.TrainStep(gen, n["D"], n.get("VGG"), hyper=config["train_config"])
        x = _inputs(config, images=True)
        calls = _record(gen)
        with FlopCounterMode(display=False) as counter:
            step(x, x["z"], x["z_im"])
    return float(counter.get_total_flops()), calls


def sample_work(config: dict) -> tuple[float, list]:
    """(FLOPs of one sampled batch, its ISLA calls' shapes)."""
    with torch.device("meta"):
        gen = ref.build(config, "meta", parts=("G",))["G"]
        x = _inputs(config, images=False)
        calls = _record(gen)
        with FlopCounterMode(display=False) as counter:
            ref.sample(gen, x["boxes"], x["labels"], x["z"], x["z_im"])
    return float(counter.get_total_flops()), calls
