"""Visual Genome layout dataset (counterpart of ``layout2img_tpu/data/vg.py``),
with the JAX package's semantics, which are the reference's (``data/vg.py``):

- a vocab JSON and the preprocessed HDF5 of ``cli/preprocess_vg.py``
  (``object_names``, ``object_boxes`` xywh in pixels, ``objects_per_image``,
  ``relationship_*``, ``image_paths``), read whole at construction;
- per item up to ``max_objects`` objects, those in relationships first,
  topped up with the others (``use_orphaned_objects``); where more than
  ``max_objects - 1`` objects are in relationships, ``max_objects`` of them
  drawn from ``np.random.default_rng((seed, index, flip))``;
- then one ``__image__`` token with the box (0, 0, 1, 1), then pad slots
  (class 0, box (-0.6, -0.6, 0.5, 0.5)): ``max_objects + 1`` slots;
- boxes normalized xywh, flip doubling x0 -> 1 - (x0 + w); images resized
  (the native decoder, or PIL bilinear) to [-1, 1], CHW here.

h5py and PIL are imported where they are used.
"""

from __future__ import annotations

import json
import os

import numpy as np

from layout2img_tpu_torch.data.coco import PAD_BOX, _default_native, decode_image


class VgLayoutDataset:
    def __init__(self, vocab_json: str, h5_path: str, image_dir: str, image_size: int = 128,
                 max_objects: int = 30, left_right_flip: bool = False,
                 use_orphaned_objects: bool = True, max_samples: int | None = None, seed: int = 0,
                 use_native: bool | None = None):
        import h5py

        self.use_native = _default_native() if use_native is None else use_native
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_objects = max_objects
        self.left_right_flip = left_right_flip
        self.use_orphaned = use_orphaned_objects
        self.max_samples = max_samples
        # items are drawn concurrently by HostDataLoader's threads: each draws
        # from its own generator, seeded by (seed, index, flip)
        self.seed = seed

        with open(vocab_json) as f:
            self.vocab = json.load(f)
        self.num_classes = len(self.vocab["object_idx_to_name"])

        self.data = {}
        with h5py.File(h5_path, "r") as f:
            for k, v in f.items():
                if k == "image_paths":
                    self.image_paths = [p.decode() if isinstance(p, bytes) else str(p) for p in v]
                else:
                    self.data[k] = np.asarray(v)

    def __len__(self) -> int:
        n = self.data["object_names"].shape[0]
        if self.max_samples is not None:
            return min(self.max_samples, n)
        return n * 2 if self.left_right_flip else n

    def valid_object_counts(self) -> np.ndarray:
        """Per-image count of valid (label != 0) object slots from the h5
        metadata (no image IO): a crowded-relationship image takes
        ``max_objects``, the others min(objects, max_objects - 1) (or only
        their relationship objects without orphans); the ``__image__`` token
        has label 0. What the object-budget guard of ``cli/train.py`` checks."""
        n = self.data["object_names"].shape[0]
        counts = np.zeros(n, np.int32)
        rel_n = self.data["relationships_per_image"]
        subs = self.data["relationship_subjects"]
        objs = self.data["relationship_objects"]
        per_img = self.data["objects_per_image"]
        for i in range(n):
            r = int(rel_n[i])
            n_rel = len(set(subs[i, :r].tolist()) | set(objs[i, :r].tolist()))
            if n_rel > self.max_objects - 1:
                counts[i] = self.max_objects
            elif self.use_orphaned:
                counts[i] = min(int(per_img[i]), self.max_objects - 1)
            else:
                counts[i] = n_rel
        return counts

    def _image(self, path: str, flip: bool) -> tuple[np.ndarray, int, int]:
        """(the decoded image, the file's width, its height)."""
        import PIL.Image

        image = decode_image(path, self.image_size, flip, self.use_native)
        with PIL.Image.open(path) as img:
            iw, ih = img.size  # the header only
        return image, iw, ih

    def __getitem__(self, index: int) -> dict:
        n = self.data["object_names"].shape[0]
        flip = index >= n
        if flip:
            index -= n
        image, iw, ih = self._image(os.path.join(self.image_dir, self.image_paths[index]), flip)

        num_objs = int(self.data["objects_per_image"][index])
        with_rels: set[int] = set()
        without_rels = set(range(num_objs))
        for r in range(int(self.data["relationships_per_image"][index])):
            s = int(self.data["relationship_subjects"][index, r])
            o = int(self.data["relationship_objects"][index, r])
            with_rels.update((s, o))
            without_rels.discard(s)
            without_rels.discard(o)

        rng = np.random.default_rng((self.seed, index, int(flip)))
        obj_idxs = list(with_rels)
        orphans = list(without_rels)
        if len(obj_idxs) > self.max_objects - 1:
            obj_idxs = list(rng.choice(obj_idxs, self.max_objects, replace=False))
        if len(obj_idxs) < self.max_objects - 1 and self.use_orphaned:
            add = min(self.max_objects - 1 - len(obj_idxs), len(orphans))
            if add:
                obj_idxs += list(rng.choice(orphans, add, replace=False))

        o_slots = self.max_objects + 1
        labels = np.zeros(o_slots, np.int32)
        boxes = np.tile(np.asarray(PAD_BOX, np.float32), (o_slots, 1))
        for i, oi in enumerate(obj_idxs):
            labels[i] = int(self.data["object_names"][index, oi])
            x, y, w, h = self.data["object_boxes"][index, oi].tolist()
            x0, y0 = x / iw, y / ih
            bw, bh = w / iw, h / ih
            if flip:
                x0 = 1 - (x0 + bw)
            boxes[i] = (x0, y0, bw, bh)
        k = len(obj_idxs)
        labels[k] = self.vocab["object_name_to_idx"]["__image__"]
        boxes[k] = (0.0, 0.0, 1.0, 1.0)
        return {"images": np.ascontiguousarray(image.transpose(2, 0, 1)), "labels": labels,
                "boxes": boxes}
