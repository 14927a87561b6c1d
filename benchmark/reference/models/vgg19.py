"""VGG19 to relu5_1, the perceptual loss's features."""

from benchmark.reference import nets


def build(config: dict, dropout_dtype):
    return nets.VGG()
