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


def write_synthetic_coco(root: str, n_images: int, width: int = 640, height: int = 480,
                         objects_per_image: int = 5, quality: int = 90,
                         seed: int = 0) -> tuple[str, str]:
    """Write a small on-disk COCO-format dataset: JPEGs and an instances JSON
    (counterpart of ``layout2img_tpu/data/synthetic.py::write_synthetic_coco``:
    the same draws in the same order, so one seed writes the same files).
    Each image is one seeded noise image rolled by 7 px per index; each has
    ``objects_per_image`` thing boxes of a quarter of its sides, classes in
    [1, 90). Returns (image_dir, instances_json_path)."""
    import json
    import os

    import PIL.Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (height, width, 3), np.uint8)
    images, anns = [], []
    for i in range(n_images):
        name = f"{i:06d}.jpg"
        PIL.Image.fromarray(np.roll(base, i * 7, axis=1)).save(os.path.join(root, name),
                                                               quality=quality)
        images.append({"id": i, "file_name": name, "width": width, "height": height})
        for j in range(objects_per_image):
            bw, bh = int(width * 0.25), int(height * 0.25)
            anns.append({
                "id": i * 100 + j, "image_id": i, "category_id": int(rng.integers(1, 90)),
                "bbox": [float(rng.integers(0, width - bw)), float(rng.integers(0, height - bh)),
                         float(bw), float(bh)],
                "iscrowd": 0,
            })
    categories = [{"id": c, "name": f"cat{c}"} for c in range(1, 91)]
    inst = os.path.join(root, "instances.json")
    with open(inst, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return root, inst


def write_synthetic_stuff(root: str, instances_json: str, max_per_image: int = 3,
                          seed: int = 0) -> str:
    """Add a COCO-Stuff stuff JSON (``stuff.json`` in ``root``) for the images
    of ``instances_json``: per image 1 to ``max_per_image`` stuff boxes of 30%
    of its sides with classes in [92, 183], where 183 is ``other`` (which the
    loader drops unless asked), and one box of 5% of its sides (below the
    loader's 2% area floor). Returns the stuff JSON's path."""
    import json
    import os

    with open(instances_json) as f:
        images = json.load(f)["images"]
    rng = np.random.default_rng(seed)
    anns = []
    for im in images:
        w, h = im["width"], im["height"]
        sizes = [0.3] * int(rng.integers(1, max_per_image + 1)) + [0.05]
        for j, frac in enumerate(sizes):
            bw, bh = int(w * frac), int(h * frac)
            anns.append({
                "id": 10**6 + im["id"] * 100 + j, "image_id": im["id"],
                "category_id": int(rng.integers(92, 184)),
                "bbox": [float(rng.integers(0, w - bw)), float(rng.integers(0, h - bh)),
                         float(bw), float(bh)],
                "iscrowd": 0,
            })
    categories = [{"id": c, "name": f"stuff{c}"} for c in range(92, 183)]
    categories.append({"id": 183, "name": "other"})
    path = os.path.join(root, "stuff.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return path


def write_synthetic_vg(root: str, n_images: int, width: int = 640, height: int = 480,
                       objects_per_image: int = 5, relationships_per_image: int = 2,
                       quality: int = 90, seed: int = 0,
                       num_classes: int = 16) -> tuple[str, str, str]:
    """Write a small on-disk VG-format dataset: JPEGs, ``vocab.json`` and
    ``train.h5`` in the schema ``cli/preprocess_vg.py`` writes and
    ``data/vg.py`` reads (int32 arrays, pixel xywh boxes, vlen-str image
    paths). Counterpart of ``layout2img_tpu/data/synthetic.py::
    write_synthetic_vg``: the same draws in the same order, so one seed
    writes the same files; ``num_classes`` (default 16, JAX's vocabulary)
    sizes the object vocabulary, ``__image__`` included (179 for VG's).

    Returns (vocab_json_path, h5_path, image_dir_root): the root is the
    dataset's image_dir, as image paths carry an ``images/`` prefix."""
    import json
    import os

    import h5py
    import PIL.Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (height, width, 3), np.uint8)

    names = ["__image__"] + [f"obj{i}" for i in range(1, num_classes)]
    vocab = {
        "object_idx_to_name": names,
        "object_name_to_idx": {n: i for i, n in enumerate(names)},
        "pred_idx_to_name": ["__in_image__", "next to"],
        "pred_name_to_idx": {"__in_image__": 0, "next to": 1},
    }
    o, r = objects_per_image, relationships_per_image
    rows = {
        "object_names": np.zeros((n_images, o), np.int32),
        "object_boxes": np.zeros((n_images, o, 4), np.int32),
        "objects_per_image": np.full(n_images, o, np.int32),
        "relationships_per_image": np.full(n_images, r, np.int32),
        "relationship_subjects": np.zeros((n_images, r), np.int32),
        "relationship_predicates": np.ones((n_images, r), np.int32),
        "relationship_objects": np.zeros((n_images, r), np.int32),
    }
    paths = []
    for i in range(n_images):
        name = f"{i:06d}.jpg"
        PIL.Image.fromarray(np.roll(base, i * 7, axis=1)).save(os.path.join(img_dir, name),
                                                               quality=quality)
        paths.append(os.path.join("images", name))
        rows["object_names"][i] = rng.integers(1, len(names), o)
        bw, bh = int(width * 0.3), int(height * 0.3)
        for j in range(o):
            rows["object_boxes"][i, j] = (int(rng.integers(0, width - bw)),
                                          int(rng.integers(0, height - bh)), bw, bh)
        rows["relationship_subjects"][i] = rng.integers(0, o, r)
        rows["relationship_objects"][i] = rng.integers(0, o, r)

    vocab_path = os.path.join(root, "vocab.json")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    h5_path = os.path.join(root, "train.h5")
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("image_paths", data=np.asarray(paths, dtype=h5py.special_dtype(vlen=str)))
        for key, v in rows.items():
            f.create_dataset(key, data=v)
    return vocab_path, h5_path, root


class SyntheticLayoutDataset:
    """Iterable of ``synthetic_batch`` batches, deterministic per seed
    (counterpart of ``layout2img_tpu/data/synthetic.py::SyntheticLayoutDataset``;
    images NCHW); ``steps`` batches per pass (None: endless)."""

    def __init__(self, batch_size: int, image_size: int = 128, num_objects: int = 8,
                 num_classes: int = 184, seed: int = 0, steps: int | None = None):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_objects = num_objects
        self.num_classes = num_classes
        self.seed = seed
        self.steps = steps

    def valid_object_counts(self) -> np.ndarray:
        return synthetic_valid_object_counts(self.num_objects)

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        i = 0
        while self.steps is None or i < self.steps:
            yield synthetic_batch(rng, self.batch_size, self.image_size, self.num_objects,
                                  self.num_classes)
            i += 1
