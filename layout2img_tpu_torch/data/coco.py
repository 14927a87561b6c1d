"""COCO-Stuff layout dataset and the threaded host loader (counterpart of
``layout2img_tpu/data/coco.py``), with the JAX package's semantics, which are
the reference's (``data/cocostuff_loader.py``):

- COCO category ids are the class indices; 0 is the ``__image__`` pad.
- Objects: area fraction above ``min_object_size`` (0.02), crowds dropped,
  ``other`` stuff dropped unless ``include_other``; with a stuff JSON and
  ``stuff_only``, only images that have stuff annotations.
- Images with ``min_objects_per_image`` to ``max_objects_per_image`` (3-8)
  objects.
- Item: the image resized (the native decoder, or PIL bilinear), in [-1, 1];
  labels (O,) int32 padded with 0; boxes (O, 4) xywh in [0, 1] padded with
  (-0.6, -0.6, 0.5, 0.5).
- Flip doubling: index >= N mirrors the image and maps x0 -> 1 - (x0 + w);
  ``max_samples`` caps the unflipped count and turns the doubling off.

Images are CHW here (the port's NCHW batches); the JAX package's are HWC,
the same values. ``fg_bg_split=True`` adds the Ours-ED family's two streams
to each item (``split_fg_bg``); ``split_fg_bg_batch`` adds them to a stacked
batch.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterator

import numpy as np

PAD_BOX = (-0.6, -0.6, 0.5, 0.5)


def decode_image(path: str, image_size: int, flip: bool, use_native: bool) -> np.ndarray:
    """One image file -> (s, s, 3) float32 in [-1, 1], as the JAX loaders
    decode it: the native decoder for JPEGs when it is available (PIL where
    it fails on the bytes), else PIL's bilinear resize."""
    if use_native and path.lower().endswith((".jpg", ".jpeg")):
        from layout2img_tpu_torch.data import native

        try:
            return native.load_image(path, image_size, flip)
        except OSError:
            pass  # not a JPEG libjpeg reads: PIL below
    import PIL.Image
    import PIL.ImageOps

    with open(path, "rb") as f, PIL.Image.open(f) as img:
        if flip:
            img = PIL.ImageOps.mirror(img)
        img = img.convert("RGB").resize((image_size, image_size), PIL.Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


def _default_native() -> bool:
    from layout2img_tpu_torch.data import native

    return native.native_available()


class CocoLayoutDataset:
    def __init__(self, image_dir: str, instances_json: str, stuff_json: str | None = None,
                 stuff_only: bool = True, image_size: int = 128, min_object_size: float = 0.02,
                 min_objects_per_image: int = 3, max_objects_per_image: int = 8,
                 left_right_flip: bool = False, include_other: bool = False,
                 max_samples: int | None = None, fg_bg_split: bool = False,
                 use_native: bool | None = None):
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_objects = max_objects_per_image
        self.left_right_flip = left_right_flip
        self.max_samples = max_samples
        self.fg_bg_split = fg_bg_split
        self.use_native = _default_native() if use_native is None else use_native

        with open(instances_json) as f:
            instances = json.load(f)
        stuff = None
        if stuff_json:
            with open(stuff_json) as f:
                stuff = json.load(f)

        self.image_id_to_filename = {}
        image_id_to_size = {}
        image_ids = []
        for im in instances["images"]:
            image_ids.append(im["id"])
            self.image_id_to_filename[im["id"]] = im["file_name"]
            image_id_to_size[im["id"]] = (im["width"], im["height"])

        idx_to_name = {cat["id"]: cat["name"] for cat in instances["categories"]}
        if stuff:
            idx_to_name.update({cat["id"]: cat["name"] for cat in stuff["categories"]})

        def keep(ann):
            w, h = ann["bbox"][2], ann["bbox"][3]
            iw, ih = image_id_to_size[ann["image_id"]]
            if (w * h) / (iw * ih) <= min_object_size:
                return False
            if idx_to_name[ann["category_id"]] == "other" and not include_other:
                return False
            return ann["iscrowd"] != 1

        objects = defaultdict(list)
        for ann in instances["annotations"]:
            if keep(ann):
                objects[ann["image_id"]].append((ann["category_id"], tuple(ann["bbox"])))
        if stuff:
            ids_with_stuff = set()
            for ann in stuff["annotations"]:
                ids_with_stuff.add(ann["image_id"])
                if keep(ann):
                    objects[ann["image_id"]].append((ann["category_id"], tuple(ann["bbox"])))
            if stuff_only:
                image_ids = [i for i in image_ids if i in ids_with_stuff]

        self.image_ids = [i for i in image_ids
                          if min_objects_per_image <= len(objects[i]) <= max_objects_per_image]
        self.objects = objects
        self.image_sizes = image_id_to_size
        self.vocab_size = 1 + max(idx_to_name) if idx_to_name else 1  # 0 == __image__

    def __len__(self) -> int:
        n = len(self.image_ids)
        if self.max_samples is not None:
            return min(n, self.max_samples)
        return n * 2 if self.left_right_flip else n

    def valid_object_counts(self) -> np.ndarray:
        """Per-image count of valid (label != 0) object slots, from the
        filtered annotation index (no image IO): what the object-budget
        guard of ``cli/train.py`` checks."""
        return np.asarray([len(self.objects[i]) for i in self.image_ids], np.int32)

    def __getitem__(self, index: int) -> dict:
        flip = False
        if index >= len(self.image_ids):
            index -= len(self.image_ids)
            flip = True
        image_id = self.image_ids[index]
        iw, ih = self.image_sizes[image_id]

        labels = np.zeros(self.max_objects, np.int32)
        boxes = np.tile(np.asarray(PAD_BOX, np.float32), (self.max_objects, 1))
        for i, (cat, (x, y, w, h)) in enumerate(self.objects[image_id]):
            x0, y0 = x / iw, y / ih
            bw, bh = w / iw, h / ih
            if flip:
                x0 = 1 - (x0 + bw)
            labels[i] = cat
            boxes[i] = (x0, y0, bw, bh)

        path = os.path.join(self.image_dir, self.image_id_to_filename[image_id])
        image = decode_image(path, self.image_size, flip, self.use_native)
        item = {"images": np.ascontiguousarray(image.transpose(2, 0, 1)), "labels": labels,
                "boxes": boxes}
        if self.fg_bg_split:
            item.update(split_fg_bg(labels, boxes))
        return item


def split_fg_bg(labels: np.ndarray, boxes: np.ndarray) -> dict:
    """The Ours-ED split of one layout (reference
    ``cocostuff_loader_ours.py:259-295``): thing ids 1-90 are the foreground
    as they are; stuff ids from 92 the background, shifted by -91; id 91 is
    dropped. Each stream keeps its objects' order, packed to the front and
    padded with class 0 and ``PAD_BOX``: ``labels_fg`` (o,) int32,
    ``boxes_fg`` (o, 4), and the same for ``bg``."""
    o = labels.shape[0]
    out = {}
    for key, sel, shift in (("fg", (labels >= 1) & (labels < 91), 0), ("bg", labels >= 92, 91)):
        lab = np.zeros(o, np.int32)
        box = np.tile(np.asarray(PAD_BOX, np.float32), (o, 1))
        idx = np.nonzero(sel)[0]
        lab[:len(idx)] = labels[idx] - shift
        box[:len(idx)] = boxes[idx]
        out[f"labels_{key}"] = lab
        out[f"boxes_{key}"] = box
    return out


def split_fg_bg_batch(batch: dict) -> dict:
    """``split_fg_bg`` over a stacked batch of numpy arrays; a batch that
    already has the streams is returned as it is."""
    if "labels_fg" in batch:
        return batch
    parts = [split_fg_bg(np.asarray(lab), np.asarray(box))
             for lab, box in zip(batch["labels"], batch["boxes"])]
    return {**batch, **{k: np.stack([p[k] for p in parts]) for k in parts[0]}}


class HostDataLoader:
    """Shuffled, fixed-shape batches assembled on a thread pool, ``prefetch``
    batches ahead. Every epoch draws ``np.random.default_rng(seed + epoch)``'s
    permutation, with the epoch counted from 0 by this object; with
    ``process_count > 1`` each process keeps the strided slice
    ``process_id::process_count`` of the same permutation, cut to
    ``len(dataset) // process_count`` so every process yields the same
    batches' count and shapes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_threads: int = 8, prefetch: int = 4, process_id: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.process_id = process_id
        self.process_count = process_count
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        import concurrent.futures as cf
        from collections import deque

        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.process_count > 1:
            order = order[self.process_id::self.process_count]
            order = order[:len(self.dataset) // self.process_count]
        self._epoch += 1
        batches = iter([order[i * self.batch_size:(i + 1) * self.batch_size]
                        for i in range(len(self))])

        def assemble(idxs):
            items = [self.dataset[int(i)] for i in idxs]
            return {k: np.stack([it[k] for it in items]) for k in items[0]}

        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            inflight = deque(pool.submit(assemble, idxs)
                             for _, idxs in zip(range(self.prefetch), batches))
            while inflight:
                fut = inflight.popleft()
                nxt = next(batches, None)
                if nxt is not None:
                    inflight.append(pool.submit(assemble, nxt))
                yield fut.result()
