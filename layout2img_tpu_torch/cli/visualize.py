"""Visualization utilities (the port's copy of ``layout2img_tpu/cli/visualize.py``,
host-only numpy and PIL; the ``.npz`` layouts are that tool's, channels last,
so both read the same files).

    python -m layout2img_tpu_torch.cli.visualize masks --npz stage.npz --out mask.png
    python -m layout2img_tpu_torch.cli.visualize layout --npz item.npz --out boxes.png

- ``masks``: dump per-stage semantic-mask argmax maps as PNGs (equivalent of
  reference ``mask_visualize.py``: argmax over the 184-channel stage mask).
- ``layout``: draw labeled boxes over an image grid (equivalent of
  ``utils_layout2img/miscs.py:draw_bbox_batch``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def colorize_classes(idx_map: np.ndarray, num_classes: int) -> np.ndarray:
    """(h, w) int class map -> (h, w, 3) uint8 via a fixed hashed palette."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 255, (num_classes, 3), dtype=np.uint8)
    palette[0] = 0
    return palette[idx_map % num_classes]


def save_mask_argmax(stage_mask: np.ndarray, path: str, num_classes: int = 184) -> None:
    """stage_mask: (h, w, num_classes) logits -> argmax color PNG."""
    import PIL.Image

    idx = np.argmax(stage_mask, axis=-1)
    PIL.Image.fromarray(colorize_classes(idx, num_classes)).save(path)


def draw_boxes(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """image (h, w, 3) in [-1,1]; boxes (o, 4) xywh [0,1]; labels (o,)."""
    img = np.clip(image * 0.5 + 0.5, 0, 1).copy()
    h, w, _ = img.shape
    rng = np.random.default_rng(1)
    for o in range(boxes.shape[0]):
        if labels[o] == 0:
            continue
        color = rng.random(3)
        x0, y0, bw, bh = boxes[o]
        x0, x1 = int(max(x0, 0) * w), int(min(x0 + bw, 1) * w) - 1
        y0, y1 = int(max(y0, 0) * h), int(min(y0 + bh, 1) * h) - 1
        if x1 <= x0 or y1 <= y0:
            continue
        img[y0:y1, x0], img[y0:y1, x1] = color, color
        img[y0, x0:x1], img[y1, x0:x1] = color, color
    return img


def main(argv=None):
    import PIL.Image

    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["masks", "layout"])
    p.add_argument("--npz", required=True, help="npz with stage_mask or image/boxes/labels")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    data = np.load(args.npz)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.mode == "masks":
        save_mask_argmax(data["stage_mask"], args.out)
    else:
        img = draw_boxes(data["image"], data["boxes"], data["labels"])
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(args.out)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
