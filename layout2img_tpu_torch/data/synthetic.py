"""Synthetic layouts with the real pipelines' padding conventions: class 0
is the ``__image__`` pad and pad slots carry the box (-0.6, -0.6, 0.5, 0.5),
which splats to an all-zero mask. Counterpart of
``layout2img_tpu/data/synthetic.py::synthetic_batch``: the same numpy draws
in the same order, so one seed gives the same batch in both packages (the
images here NCHW)."""

from __future__ import annotations

import numpy as np

PAD_BOX = (-0.6, -0.6, 0.5, 0.5)


def synthetic_layouts(rng: np.random.Generator, b: int, o: int, num_classes: int,
                      min_objects: int = 3, max_objects: int | None = None) -> dict:
    """``{"boxes": (b, o, 4) f32 xywh, "labels": (b, o) int32}``; each layout
    holds n ~ U[min_objects, max_objects] valid objects (default max: o) at
    the front and pads the rest."""
    max_objects = o if max_objects is None else max_objects
    labels = np.zeros((b, o), np.int32)
    boxes = np.tile(np.asarray(PAD_BOX, np.float32), (b, o, 1))
    for i in range(b):
        n = int(rng.integers(min_objects, max_objects + 1))
        labels[i, :n] = rng.integers(1, num_classes, n)
        xy = rng.uniform(0, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        boxes[i, :n] = np.concatenate([xy, wh], -1).astype(np.float32)
    return {"boxes": boxes, "labels": labels}


def synthetic_valid_object_counts(o: int, min_objects: int = 3) -> np.ndarray:
    """Every valid-object count ``synthetic_layouts`` can draw: n ~ U[min, o],
    unbounded over steps, so the object-budget guard sees the true max."""
    return np.arange(min_objects, o + 1, dtype=np.int32)


def synthetic_batch(rng: np.random.Generator, batch_size: int, image_size: int = 128,
                    num_objects: int = 8, num_classes: int = 184, min_objects: int = 3) -> dict:
    """``{"images": (b, 3, s, s) f32 uniform in [-1, 1], "boxes", "labels"}``
    as ``synthetic_layouts`` makes them; the images are drawn first."""
    images = rng.uniform(-1, 1, (batch_size, image_size, image_size, 3)).astype(np.float32)
    layout = synthetic_layouts(rng, batch_size, num_objects, num_classes, min_objects=min_objects)
    return {"images": np.ascontiguousarray(images.transpose(0, 3, 1, 2)), **layout}
