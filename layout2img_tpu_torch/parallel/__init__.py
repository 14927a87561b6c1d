"""Data-parallel training across processes (counterpart of
``layout2img_tpu/parallel/``): ``mesh.py``."""
