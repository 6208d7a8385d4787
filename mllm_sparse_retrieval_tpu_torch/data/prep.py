"""Dataset preparation: Karpathy JSON -> CSVs, few-shot sampling, sanity
checks (the port's copy of the JAX package's ``data/prep.py``).

- ``karpathy_json_to_csvs``: the train split merges the 'train' and
  'restval' images; val and test keep their own (the Karpathy convention);
- ``sample_few_shot_csv``: a random subset of images, seed 0 by default,
  with all their captions;
- ``check_captions_per_image``: the captions-per-image histogram.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Dict, List, Optional, Tuple

COCO_COLUMNS = ["imgid", "filepath", "filename", "caption", "sentid"]
FLICKR_COLUMNS = ["imgid", "filename", "caption", "sentid"]


def karpathy_json_to_csvs(
    json_path: str,
    out_dir: str,
    data_name: str,
) -> Dict[str, str]:
    """Split a Karpathy ``dataset.json`` into {name}_{split}.csv files.

    Returns {split: csv_path}. 'train' and 'restval' images both land in the
    train CSV (the Karpathy convention the reference follows).
    """
    if data_name not in ("coco", "flickr"):
        raise ValueError("data_name must be coco or flickr")
    with open(json_path) as f:
        data = json.load(f)

    rows: Dict[str, List[List[str]]] = {"train": [], "val": [], "test": []}
    for img in data["images"]:
        split = img["split"]
        if split == "restval":
            split = "train"
        if split not in rows:
            continue
        for sent in img["sentences"]:
            if data_name == "coco":
                rows[split].append([
                    str(img["imgid"]), img.get("filepath", ""),
                    img["filename"], sent["raw"], str(sent["sentid"])])
            else:
                rows[split].append([
                    str(img["imgid"]), img["filename"], sent["raw"],
                    str(sent["sentid"])])

    os.makedirs(out_dir, exist_ok=True)
    header = COCO_COLUMNS if data_name == "coco" else FLICKR_COLUMNS
    out = {}
    for split, split_rows in rows.items():
        path = os.path.join(out_dir, f"{data_name}_{split}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(split_rows)
        out[split] = path
    return out


def sample_few_shot_csv(
    train_csv: str,
    out_csv: str,
    num_images: int,
    seed: int = 0,
) -> int:
    """Sample ``num_images`` random images (with all their captions) from a
    train CSV into ``{name}_train_{num}.csv``. Returns rows written."""
    with open(train_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    by_img: Dict[str, List[List[str]]] = {}
    order: List[str] = []
    for row in rows:
        if row[0] not in by_img:
            by_img[row[0]] = []
            order.append(row[0])
        by_img[row[0]].append(row)

    rng = random.Random(seed)
    chosen = rng.sample(order, min(num_images, len(order)))
    written = 0
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for img in chosen:
            for row in by_img[img]:
                writer.writerow(row)
                written += 1
    return written


def check_captions_per_image(csv_path: str) -> Dict[int, int]:
    """Histogram of captions-per-image (COCO test has 4,990 images with 5
    captions and 10 with 6; Flickr has 1,000 x 5)."""
    counts: Dict[str, int] = {}
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            counts[row[0]] = counts.get(row[0], 0) + 1
    hist: Dict[int, int] = {}
    for c in counts.values():
        hist[c] = hist.get(c, 0) + 1
    return hist
