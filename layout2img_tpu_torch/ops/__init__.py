"""Ops of the port. Importing the package registers the ISLA kernels'
``torch.library`` operators (``ops/isla.py``), which a saved ``torch.export``
program of the generator names: ``torch.export.load`` needs them first."""

from layout2img_tpu_torch.ops import isla  # noqa: F401
