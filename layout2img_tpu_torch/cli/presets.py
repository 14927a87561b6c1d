"""Experiment presets (the port's own copy of ``layout2img_tpu/cli/presets.py``):
one ``--model`` flag names the generator/discriminator pair and the image
size of each of the reference's train scripts.

The special families (``ours_ed``, fg/bg two-stream; ``layout2im``,
CVAE-GAN) are in the map as in the JAX package. Their preset names are not
presets of ``make_generator``/``make_discriminator``: their trainers build
the networks with the families' own constructors (``train/step_bgfg.py``,
``train/step_layout2im.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Experiment:
    gen_preset: str
    disc_preset: str
    image_size: int
    description: str
    # special families route through dedicated trainers, not the GAN step
    special: bool = False


EXPERIMENTS: dict[str, Experiment] = {
    # train_ours_d.py / train_app.py: v2 stage-mask G + app D ("Ours-D" base)
    "ours_d": Experiment("ours_d_base128", "d128_app", 128, "v2 stage-mask G + appearance D"),
    # train_context_app_v2.py: context + stage masks (Ours-D final)
    "context_app_v2": Experiment("ours_d_context128", "d128_app", 128,
                                 "context transformer + stage masks + app D"),
    # train_context_app.py
    "context_app": Experiment("context128", "d128_app", 128, "context G + app D"),
    # train_context_nogeo.py
    "context_nogeo": Experiment("context128_nogeo", "d128", 128, "no-geometry ablation"),
    # train_context_app_nogeo.py
    "context_app_nogeo": Experiment("context128_nogeo", "d128_app", 128,
                                    "no-geometry ablation + app D"),
    # train_graph_context_app.py
    "graph_context_app": Experiment("graph128", "d128_app", 128, "GCN context + app D"),
    # train_lostGan.py
    "lostgan": Experiment("lostgan128", "d128", 128, "LostGAN v1 baseline"),
    # train_context_part.py: 3-part masks + plain CombineDiscriminator128
    "context_part": Experiment("context128_part", "d128", 128, "context G with 3-part masks"),
    # 256px training (regress canvas 64, occupancy canvas 128: the ours_d_base256 preset)
    "ours_d_256": Experiment("ours_d_base256", "d256", 256, "v2 stage-mask G at 256px"),
    # train_ours.py fg/bg two-stream family ("Ours-ED", 64px)
    "ours_ed": Experiment("bgfg64", "d64", 64, "fg/bg two-stream G (Ours-ED)", special=True),
    # train_ours_layout2img.py CVAE-GAN family (64px)
    "layout2im": Experiment("layout2im64", "layout2im", 64, "layout2im CVAE-GAN", special=True),
}


def experiment(name: str) -> Experiment:
    """The experiment ``name``; unknown names raise ``ValueError``."""
    if name not in EXPERIMENTS:
        raise ValueError(f"unknown --model {name!r}. Choices: {', '.join(sorted(EXPERIMENTS))}")
    return EXPERIMENTS[name]


def dataset_spec(dataset: str) -> tuple[int, int]:
    """(num_classes, num_objects): reference train_ours_d.py:44-45."""
    if dataset == "coco":
        return 184, 8
    if dataset == "vg":
        return 179, 31
    if dataset == "synthetic":
        return 184, 8
    raise ValueError(dataset)
