"""Prepare ground-truth reference images for FID/IS (the port's copy of
``layout2img_tpu/cli/prepare_eval_images.py``, host-only PIL).

    python -m layout2img_tpu_torch.cli.prepare_eval_images --src val2017 --dst real128 --size 128

Equivalent of reference ``generate_original_image.py`` (resize the val set
to size x size) and ``resizeimg.py`` (128 -> 64). Note: the reference's
eval-prep normalizes with true ImageNet stats while its datasets use 0.5/0.5
(SURVEY.md section 2.7); this tool just resizes pixels, which is what FID/IS
consume.
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    import PIL.Image

    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="source image dir (e.g. val2017)")
    p.add_argument("--dst", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.dst, exist_ok=True)
    files = sorted(
        glob.glob(os.path.join(args.src, "*.jpg")) + glob.glob(os.path.join(args.src, "*.png"))
    )
    if args.limit:
        files = files[: args.limit]
    for i, f in enumerate(files):
        with PIL.Image.open(f) as im:
            im = im.convert("RGB").resize((args.size, args.size), PIL.Image.BILINEAR)
            im.save(os.path.join(args.dst, os.path.basename(f)))
    print(f"wrote {len(files)} images at {args.size}x{args.size} to {args.dst}")


if __name__ == "__main__":
    main()
