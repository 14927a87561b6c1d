"""Ours-D's generator at 128 px: box attention, stage masks, PSP head."""

from benchmark.reference import nets


def build(config: dict, dropout_dtype):
    return nets.Generator(config["num_classes"], ch=config["ch"], z_dim=config["z_dim"],
                          dropout_dtype=dropout_dtype)
