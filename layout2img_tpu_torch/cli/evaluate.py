"""Evaluation CLI (counterpart of ``layout2img_tpu/cli/evaluate.py``): the
reference's ``IS.py`` (Inception Score over samples, 3 splits), FID, KID
(unbiased MMD, meaningful at small sample counts) and LPIPS diversity
(``test_lpips.py``), with InceptionV3 and AlexNet on the GPU.

Input modes, exactly one of (``IS.py:40-79``):
  --dir DIR          flat image directory
  --npy FILE         .npy array of images
  --dir_list FILE    text file, one image directory per line (IS per dir)
  --superdir DIR     scans DIR/result*/images subdirs (IS per subdir)
FID/KID/LPIPS compare --dir (or --npy) against --ref_dir.

Images are decoded in batches (bounded host RAM, arbitrarily large dirs).
The output lines are the JAX CLI's, word for word.

Examples:
  python -m layout2img_tpu_torch.cli.evaluate is --dir samples/
  python -m layout2img_tpu_torch.cli.evaluate fid --dir samples/ --ref_dir real128/
  python -m layout2img_tpu_torch.cli.evaluate kid --dir samples/ --ref_dir real128/
  python -m layout2img_tpu_torch.cli.evaluate lpips --dir samples/ --ref_dir real128/
  python -m layout2img_tpu_torch.cli.evaluate fid --dir real128/ --save_stats ref.npz
  python -m layout2img_tpu_torch.cli.evaluate fid --dir samples/ --ref_stats ref.npz

Without ``--inception_weights`` (a torchvision ``inception_v3`` ``.pth``)
Inception has seeded random filters: the numbers are a pipeline check, not
comparable with published ones, nor with the JAX package's random filters.
Runs on one GPU (``--device``, default cuda); ``--device cpu`` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterator

import numpy as np

_EXTS = ("*.jpg", "*.jpeg", "*.png")


def list_images(path: str, limit: int | None = None) -> list[str]:
    files = sorted(f for pat in _EXTS for f in glob.glob(os.path.join(path, pat)))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images in {path}")
    return files


def iter_file_batches(files: list[str], batch_size: int, resize: int = 0) -> Iterator[np.ndarray]:
    """Decode ``files`` in batches -> (<=b, h, w, 3) float32 in [-1, 1]."""
    import PIL.Image

    for i in range(0, len(files), batch_size):
        chunk = []
        for f in files[i : i + batch_size]:
            with PIL.Image.open(f) as im:
                im = im.convert("RGB")
                if resize:
                    im = im.resize((resize, resize), PIL.Image.BILINEAR)
                chunk.append(np.asarray(im, np.float32))
        yield np.stack(chunk) / 255.0 * 2.0 - 1.0


def _npy_batches(path: str, batch_size: int, limit: int | None,
                 npy_range: str = "auto") -> Iterator[np.ndarray]:
    """Yield batches normalized to [-1, 1].

    ``npy_range`` pins the input domain: "unit" ([0, 1] floats), "pm1"
    ([-1, 1]), "255" ([0, 255]), or "auto" — a heuristic on min/max. The
    heuristic misreads a legitimately all-nonnegative [-1, 1] array as
    [0, 1]; pass an explicit range for such data.
    """
    arr = np.load(path)
    if limit:
        arr = arr[:limit]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
    else:
        arr = arr.astype(np.float32)
        if npy_range == "auto":
            lo, hi = float(arr.min()), float(arr.max())
            if hi > 2.0:
                npy_range = "255"
            elif lo >= 0.0:
                npy_range = "unit"
            else:
                npy_range = "pm1"
            print(f"NOTE: {path} floats in [{lo:.2f}, {hi:.2f}]; treating as "
                  f"'{npy_range}' (pass --npy_range to override)")
        if npy_range == "255":
            arr = arr / 255.0 * 2.0 - 1.0
        elif npy_range == "unit":
            arr = arr * 2.0 - 1.0
        elif npy_range != "pm1":
            raise SystemExit(f"unknown --npy_range {npy_range!r}")
    for i in range(0, arr.shape[0], batch_size):
        yield arr[i : i + batch_size]


def resolve_sources(args) -> list[tuple[str, Iterator[np.ndarray]]]:
    """-> [(name, batch iterator)]; one entry except dir_list/superdir."""
    limit = args.limit or None
    given = [bool(args.dir), bool(args.npy), bool(args.dir_list), bool(args.superdir)]
    if sum(given) != 1:
        raise SystemExit("give exactly one of --dir / --npy / --dir_list / --superdir")
    if args.dir:
        return [(args.dir, iter_file_batches(list_images(args.dir, limit),
                                             args.batch_size, args.resize))]
    if args.npy:
        return [(args.npy, _npy_batches(args.npy, args.batch_size, limit,
                                        getattr(args, "npy_range", "auto")))]
    if args.dir_list:
        with open(args.dir_list) as f:
            dirs = [line.strip() for line in f if line.strip()]
        return [(d, iter_file_batches(list_images(d, limit), args.batch_size, args.resize))
                for d in dirs]
    # superdir: DIR/result*/images (reference IS.py:70-79)
    out = []
    for fn in sorted(os.listdir(args.superdir)):
        if not fn.startswith("result"):
            continue
        d = os.path.join(args.superdir, fn, "images")
        if os.path.isdir(d):
            out.append((d, iter_file_batches(list_images(d, limit),
                                             args.batch_size, args.resize)))
    if not out:
        raise FileNotFoundError(f"no result*/images dirs under {args.superdir}")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["is", "fid", "kid", "lpips"])
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--kid_subsets", type=int, default=100)
    p.add_argument("--dir", default="")
    p.add_argument("--npy", default="", help=".npy image array input")
    p.add_argument("--npy_range", default="auto", choices=["auto", "unit", "pm1", "255"],
                   help="float domain of --npy data (auto = min/max heuristic; "
                        "pin it for all-nonnegative [-1,1] arrays)")
    p.add_argument("--dir_list", default="", help="file listing image dirs (IS per dir)")
    p.add_argument("--superdir", default="", help="scan DIR/result*/images (IS per subdir)")
    p.add_argument("--ref_dir", default="")
    p.add_argument("--ref_stats", default="",
                   help="precomputed FID reference stats .npz (mu/sigma, pytorch-fid "
                        "convention) — replaces --ref_dir so the real-image pass runs once")
    p.add_argument("--save_stats", default="",
                   help="fid mode: write the INPUT source's mu/sigma to this .npz (build a "
                        "reusable reference with `fid --dir real128/ --save_stats ref.npz`)")
    p.add_argument("--splits", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--resize", type=int, default=0,
                   help="resize decoded images (0 = keep; batches must be uniform)")
    p.add_argument("--inception_weights", default="", help="torchvision inception_v3 .pth")
    p.add_argument("--lpips_weights", default="")
    p.add_argument("--lpips_backbone", default="",
                   help="torchvision alexnet .pth (needed when --lpips_weights "
                        "is the official lins-only lpips checkpoint)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' must be asked for")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from layout2img_tpu_torch.device import resolve_device
    from layout2img_tpu_torch.eval.metrics import tf32_off

    args = parse_args(argv)
    device = resolve_device(args.device)
    limit = args.limit or None
    sources = resolve_sources(args)

    if args.mode != "is" and len(sources) != 1:
        raise SystemExit(f"{args.mode} takes a single input source")
    if args.mode in ("kid", "lpips") and not args.ref_dir:
        raise SystemExit("kid requires --ref_dir (raw features are needed; FID-style mu/sigma "
                         "stats do not determine the MMD)" if args.mode == "kid"
                         else "lpips requires --ref_dir")
    if args.mode == "fid" and args.ref_dir and args.ref_stats:
        raise SystemExit("give --ref_dir or --ref_stats, not both")
    if args.mode == "fid" and not (args.ref_dir or args.ref_stats or args.save_stats):
        raise SystemExit("fid requires --ref_dir or --ref_stats "
                         "(or --save_stats to only build stats)")

    def ref_batches():
        return iter_file_batches(list_images(args.ref_dir, limit), args.batch_size, args.resize)

    if args.mode in ("is", "fid", "kid"):
        from layout2img_tpu_torch.eval.inception import load_inception
        from layout2img_tpu_torch.eval.metrics import (fid_from_features, inception_score,
                                                       run_inception_batches)

        if not args.inception_weights:
            print("WARNING: no --inception_weights; random filters (numbers not comparable)")
        net = load_inception(args.inception_weights, device)

        if args.mode == "is":
            for name, batches in sources:
                _, probs = run_inception_batches(net, batches)
                mean, std = inception_score(probs, args.splits)
                print(f"{name}: IS: {mean:.4f} +/- {std:.4f}  (n={len(probs)}, splits={args.splits})")
        elif args.mode == "kid":
            from layout2img_tpu_torch.eval.metrics import kid_from_features

            feats, _ = run_inception_batches(net, sources[0][1])
            ref_feats, _ = run_inception_batches(net, ref_batches())
            mean, std = kid_from_features(feats, ref_feats, args.kid_subset_size, args.kid_subsets)
            print(f"KID: {mean * 1000:.4f} +/- {std * 1000:.4f} (x10^-3)  "
                  f"(n={len(feats)} vs {len(ref_feats)}, "
                  f"subset={min(args.kid_subset_size, len(feats), len(ref_feats))}"
                  f"x{args.kid_subsets})")
        else:
            from layout2img_tpu_torch.eval.metrics import (feature_stats, frechet_distance,
                                                           load_feature_stats, save_feature_stats)

            feats, _ = run_inception_batches(net, sources[0][1])
            mu, sigma = feature_stats(feats)
            if args.save_stats:
                save_feature_stats(args.save_stats, mu, sigma, len(feats))
                print(f"saved stats for {len(feats)} images -> {args.save_stats}")
            if args.ref_stats:
                ref_mu, ref_sigma, ref_n = load_feature_stats(args.ref_stats)
                src = f"{args.ref_stats}, n={ref_n}" if ref_n >= 0 else args.ref_stats
                print(f"FID: {frechet_distance(mu, sigma, ref_mu, ref_sigma):.4f}"
                      f"  (ref: {src})")
            elif args.ref_dir:
                ref_feats, _ = run_inception_batches(net, ref_batches())
                print(f"FID: {fid_from_features(feats, ref_feats):.4f}")
    else:
        from layout2img_tpu_torch.eval.lpips import load_lpips

        lp = load_lpips(args.lpips_weights, args.lpips_backbone or None, device)
        dists = []
        with torch.inference_mode(), tf32_off():
            for a, b in zip(sources[0][1], ref_batches()):
                n = min(a.shape[0], b.shape[0])
                a, b = (torch.from_numpy(np.ascontiguousarray(x[:n])).permute(0, 3, 1, 2).to(device)
                        for x in (a, b))
                dists.append(lp(b, a).float().cpu().numpy())
        d = np.concatenate(dists)
        print(f"LPIPS: {d.mean():.4f} +/- {d.std():.4f}  (n={len(d)})")


if __name__ == "__main__":
    main()
