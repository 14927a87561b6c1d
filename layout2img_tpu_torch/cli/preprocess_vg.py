"""Visual Genome preprocessing: raw VG JSONs -> {train,val,test}.h5 + vocab.json
(the port's own copy of ``layout2img_tpu/cli/preprocess_vg.py``: the same
filters, splits and files).

    python -m layout2img_tpu_torch.cli.preprocess_vg --vg_dir datasets/vg

From-scratch equivalent of reference ``scripts/preprocess_vg.py`` (sg2im
lineage) producing the same HDF5 schema consumed by
``data/vg.py::VgLayoutDataset``:

  image_paths, object_names (n, max_o), object_boxes (n, max_o, 4) xywh px,
  objects_per_image, relationship_subjects/predicates/objects (n, max_r),
  relationships_per_image

and a vocab.json with object_idx_to_name / object_name_to_idx (index 0 ==
``__image__``) and pred vocab.

Filtering mirrors the reference defaults (:56-70): images >= 200px on both
sides, object alias canonicalization, object vocab by >= 2000 training
instances, boxes >= 32px on both sides, 3..30 objects per image,
predicate vocab by >= 500 instances, 1..30 relationships per image.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vg_dir", default="datasets/vg")
    p.add_argument("--splits_json", default="")
    p.add_argument("--images_json", default="image_data.json")
    p.add_argument("--objects_json", default="objects.json")
    p.add_argument("--relationships_json", default="relationships.json")
    p.add_argument("--object_aliases", default="object_alias.txt")
    p.add_argument("--relationship_aliases", default="relationship_alias.txt")
    p.add_argument("--min_image_size", type=int, default=200)
    p.add_argument("--min_object_instances", type=int, default=2000)
    p.add_argument("--min_relationship_instances", type=int, default=500)
    p.add_argument("--min_object_size", type=int, default=32)
    p.add_argument("--min_objects_per_image", type=int, default=3)
    p.add_argument("--max_objects_per_image", type=int, default=30)
    p.add_argument("--min_relationships_per_image", type=int, default=1)
    p.add_argument("--max_relationships_per_image", type=int, default=30)
    p.add_argument("--val_fraction", type=float, default=0.05)
    p.add_argument("--test_fraction", type=float, default=0.05)
    p.add_argument("--output_dir", default="")
    return p.parse_args(argv)


def load_aliases(path: str) -> dict[str, str]:
    aliases = {}
    if not os.path.isfile(path):
        return aliases
    with open(path) as f:
        for line in f:
            parts = [s.strip() for s in line.strip().split(",")]
            for p in parts[1:]:
                aliases[p] = parts[0]
    return aliases


def canon(name: str, aliases: dict[str, str]) -> str:
    name = name.lower().strip()
    return aliases.get(name, name)


def main(argv=None):
    import h5py

    args = parse_args(argv)
    vg = args.vg_dir
    out_dir = args.output_dir or vg
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(vg, args.images_json)) as f:
        images = json.load(f)
    with open(os.path.join(vg, args.objects_json)) as f:
        objects = json.load(f)
    with open(os.path.join(vg, args.relationships_json)) as f:
        relationships = json.load(f)
    obj_aliases = load_aliases(os.path.join(vg, args.object_aliases))
    rel_aliases = load_aliases(os.path.join(vg, args.relationship_aliases))

    # 1. image filter + splits
    id_to_image = {
        im["image_id"]: im
        for im in images
        if im["width"] >= args.min_image_size and im["height"] >= args.min_image_size
    }
    if args.splits_json and os.path.isfile(os.path.join(vg, args.splits_json)):
        with open(os.path.join(vg, args.splits_json)) as f:
            splits = json.load(f)
        splits = {k: [i for i in v if i in id_to_image] for k, v in splits.items()}
    else:
        ids = sorted(id_to_image)
        rng = np.random.default_rng(0)
        rng.shuffle(ids)
        n = len(ids)
        n_val = int(n * args.val_fraction)
        n_test = int(n * args.test_fraction)
        splits = {
            "val": ids[:n_val],
            "test": ids[n_val : n_val + n_test],
            "train": ids[n_val + n_test :],
        }

    train_ids = set(splits["train"])

    # 2. object vocab from training instances
    def iter_objects(entry):
        for obj in entry.get("objects", []):
            names = obj.get("names") or ([obj["name"]] if "name" in obj else [])
            if not names:
                continue
            yield obj, canon(names[0], obj_aliases)

    name_counts: Counter = Counter()
    for entry in objects:
        if entry["image_id"] in train_ids:
            for _, name in iter_objects(entry):
                name_counts[name] += 1
    kept_names = {n for n, c in name_counts.items() if c >= args.min_object_instances}
    obj_idx_to_name = ["__image__"] + sorted(kept_names)
    obj_name_to_idx = {n: i for i, n in enumerate(obj_idx_to_name)}

    # 3. predicate vocab
    pred_counts: Counter = Counter()
    for entry in relationships:
        if entry["image_id"] in train_ids:
            for rel in entry.get("relationships", []):
                pred_counts[canon(rel["predicate"], rel_aliases)] += 1
    kept_preds = {p for p, c in pred_counts.items() if c >= args.min_relationship_instances}
    pred_idx_to_name = ["__in_image__"] + sorted(kept_preds)
    pred_name_to_idx = {n: i for i, n in enumerate(pred_idx_to_name)}

    vocab = {
        "object_idx_to_name": obj_idx_to_name,
        "object_name_to_idx": obj_name_to_idx,
        "pred_idx_to_name": pred_idx_to_name,
        "pred_name_to_idx": pred_name_to_idx,
    }
    with open(os.path.join(out_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)

    objects_by_image = {e["image_id"]: e for e in objects}
    rels_by_image = {e["image_id"]: e for e in relationships}

    # 4. encode each split
    for split, ids in splits.items():
        max_o, max_r = args.max_objects_per_image, args.max_relationships_per_image
        rows: dict[str, list] = defaultdict(list)
        for image_id in ids:
            im = id_to_image[image_id]
            entry = objects_by_image.get(image_id)
            if entry is None:
                continue
            # filter objects
            kept = []
            obj_id_to_slot = {}
            for obj, name in iter_objects(entry):
                if name not in obj_name_to_idx:
                    continue
                if obj["w"] < args.min_object_size or obj["h"] < args.min_object_size:
                    continue
                if len(kept) >= max_o:
                    break
                obj_id_to_slot[obj["object_id"]] = len(kept)
                kept.append((obj_name_to_idx[name], (obj["x"], obj["y"], obj["w"], obj["h"])))
            if not (args.min_objects_per_image <= len(kept) <= max_o):
                continue
            # relationships among kept objects
            rels = []
            for rel in rels_by_image.get(image_id, {}).get("relationships", []):
                pred = canon(rel["predicate"], rel_aliases)
                if pred not in pred_name_to_idx:
                    continue
                s = rel["subject"].get("object_id")
                o = rel["object"].get("object_id")
                if s in obj_id_to_slot and o in obj_id_to_slot and len(rels) < max_r:
                    rels.append((obj_id_to_slot[s], pred_name_to_idx[pred], obj_id_to_slot[o]))
            if len(rels) < args.min_relationships_per_image:
                continue

            names = np.zeros(max_o, np.int32)
            boxes = np.zeros((max_o, 4), np.int32)
            for i, (cls, bb) in enumerate(kept):
                names[i] = cls
                boxes[i] = bb
            subs = np.zeros(max_r, np.int32)
            preds = np.zeros(max_r, np.int32)
            objs_r = np.zeros(max_r, np.int32)
            for i, (s, pr, o) in enumerate(rels):
                subs[i], preds[i], objs_r[i] = s, pr, o

            url = im.get("url", "")
            rows["image_paths"].append(os.path.join(*url.split("/")[-2:]) if url else f"{image_id}.jpg")
            rows["object_names"].append(names)
            rows["object_boxes"].append(boxes)
            rows["objects_per_image"].append(len(kept))
            rows["relationship_subjects"].append(subs)
            rows["relationship_predicates"].append(preds)
            rows["relationship_objects"].append(objs_r)
            rows["relationships_per_image"].append(len(rels))

        h5_path = os.path.join(out_dir, f"{split}.h5")
        with h5py.File(h5_path, "w") as f:
            f.create_dataset(
                "image_paths",
                data=np.asarray(rows["image_paths"], dtype=h5py.special_dtype(vlen=str)),
            )
            for key in (
                "object_names", "object_boxes", "objects_per_image",
                "relationship_subjects", "relationship_predicates",
                "relationship_objects", "relationships_per_image",
            ):
                f.create_dataset(key, data=np.asarray(rows[key]))
        print(f"{split}: {len(rows['image_paths'])} images -> {h5_path}")


if __name__ == "__main__":
    main()
