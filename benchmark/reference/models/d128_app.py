"""The 128 px layout discriminator with the app head."""

from benchmark.reference import nets


def build(config: dict, dropout_dtype):
    return nets.Discriminator(config["num_classes"], ch=config["ch"], app_head=True)
