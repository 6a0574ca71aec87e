"""Dataset preparation CLI: the port's own copy of
``sam3_lora_tpu/cli/prepare_data.py`` (which imports no JAX; reference
``prepare_data.py`` + ``convert_roboflow_to_coco.py`` +
``prepare_data_split.py``):

* ``scaffold``  — create the expected ``<root>/{train,valid,test}`` layout
* ``validate``  — check COCO annotation files for integrity (ids, bboxes,
  polygon arity, image files present, 3-digit Roboflow category ids)
* ``fix-roboflow`` — rewrite 3-digit class ids to sequential ids
* ``split``     — split a single ``train`` folder into train/valid

``python -m sam3_lora_tpu_torch.cli.prepare_data validate --data-dir data``
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
from pathlib import Path

SPLITS = ("train", "valid", "test")
ANN = "_annotations.coco.json"


def cmd_scaffold(args):
    root = Path(args.data_dir)
    for s in SPLITS:
        (root / s).mkdir(parents=True, exist_ok=True)
    print(f"created {root}/{{train,valid,test}}")
    print(f"place images + {ANN} in each split directory")


def _load(split_dir: Path):
    f = split_dir / ANN
    if not f.exists():
        return None
    with open(f) as fh:
        return json.load(fh)


def cmd_validate(args):
    root = Path(args.data_dir)
    ok = True
    for s in SPLITS:
        coco = _load(root / s)
        if coco is None:
            print(f"[{s}] missing {ANN} — skipped")
            continue
        imgs = {im["id"]: im for im in coco.get("images", [])}
        cats = {c["id"] for c in coco.get("categories", [])}
        n_bad_box = n_bad_seg = n_orphan = n_missing_file = 0
        for im in imgs.values():
            if not (root / s / im["file_name"]).exists():
                n_missing_file += 1
        for a in coco.get("annotations", []):
            if a["image_id"] not in imgs:
                n_orphan += 1
            x, y, w, h = a.get("bbox", [0, 0, 0, 0])
            if w <= 0 or h <= 0:
                n_bad_box += 1
            for poly in a.get("segmentation", []) or []:
                if isinstance(poly, list) and (len(poly) < 6 or len(poly) % 2):
                    n_bad_seg += 1
        three_digit = [c for c in cats if c >= 100]
        print(
            f"[{s}] {len(imgs)} imgs, {len(coco.get('annotations', []))} anns, "
            f"{len(cats)} cats | missing files {n_missing_file}, orphan anns "
            f"{n_orphan}, degenerate boxes {n_bad_box}, bad polygons {n_bad_seg}"
            + (f", 3-digit cat ids {three_digit} (run fix-roboflow)" if three_digit else "")
        )
        ok &= not (n_missing_file or n_orphan)
    print("OK" if ok else "PROBLEMS FOUND")
    return 0 if ok else 1


def cmd_fix_roboflow(args):
    root = Path(args.data_dir)
    for s in SPLITS:
        coco = _load(root / s)
        if coco is None:
            continue
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        remap = {c["id"]: i + 1 for i, c in enumerate(cats)}
        if all(old == new for old, new in remap.items()):
            print(f"[{s}] ids already sequential")
            continue
        for c in coco["categories"]:
            c["id"] = remap[c["id"]]
        for a in coco["annotations"]:
            a["category_id"] = remap.get(a["category_id"], a["category_id"])
        with open(root / s / ANN, "w") as f:
            json.dump(coco, f)
        print(f"[{s}] remapped {len(remap)} category ids -> 1..{len(remap)}")


def cmd_split(args):
    root = Path(args.data_dir)
    src = root / "train"
    dst = root / "valid"
    coco = _load(src)
    if coco is None:
        raise SystemExit(f"no {ANN} in {src}")
    rng = random.Random(args.seed)
    img_ids = [im["id"] for im in coco["images"]]
    rng.shuffle(img_ids)
    n_val = max(1, int(len(img_ids) * args.val_fraction))
    val_ids = set(img_ids[:n_val])

    def subset(ids):
        return {
            "images": [im for im in coco["images"] if im["id"] in ids],
            "annotations": [a for a in coco["annotations"] if a["image_id"] in ids],
            "categories": coco["categories"],
        }

    dst.mkdir(parents=True, exist_ok=True)
    val = subset(val_ids)
    train = subset(set(img_ids) - val_ids)
    for im in val["images"]:
        sp, dp = src / im["file_name"], dst / im["file_name"]
        if sp.exists():
            shutil.move(str(sp), str(dp))
    with open(dst / ANN, "w") as f:
        json.dump(val, f)
    with open(src / ANN, "w") as f:
        json.dump(train, f)
    print(
        f"split: {len(train['images'])} train / {len(val['images'])} valid images"
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="COCO dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (
        ("scaffold", cmd_scaffold),
        ("validate", cmd_validate),
        ("fix-roboflow", cmd_fix_roboflow),
        ("split", cmd_split),
    ):
        sp = sub.add_parser(name)
        sp.add_argument("--data-dir", required=True)
        if name == "split":
            sp.add_argument("--val-fraction", type=float, default=0.2)
            sp.add_argument("--seed", type=int, default=0)
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
