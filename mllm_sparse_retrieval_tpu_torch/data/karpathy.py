"""Karpathy-split COCO / Flickr30k caption corpora (a copy of the JAX
package's ``data/karpathy.py``).

``CrossModalCorpus`` is a plain in-memory corpus: ordered id lists and
id -> content maps for both modalities, the ground truth (``img2text`` is
1 -> ~5, ``text2img`` is 1 -> 1), and the two example views, one row per
image with its first caption (``examples_single``) and one row per caption
(``examples_full``). Batching is the caller's.

CSV layouts:

- coco:   ``imgid,filepath,filename,caption,sentid``
- flickr: ``imgid,filename,caption,sentid``
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class Example:
    """One retrieval example: a caption paired with its image."""

    text: str
    image_path: str
    text_id: str
    img_id: str


class CrossModalCorpus:
    """In-memory Karpathy CSV corpus with ground-truth maps.

    ``few_shot_sum`` reads ``{data_name}_{split}_{few_shot_sum}.csv``
    instead of ``{data_name}_{split}.csv``; ``image_root`` overrides the
    image directory (``<data_root>/coco``, ``<data_root>/flickr/
    flickr30k-images``).
    """

    def __init__(
        self,
        data_name: str,
        split: str = "test",
        data_root: str = "/root/reference/data",
        few_shot_sum: Optional[int] = None,
        image_root: Optional[str] = None,
    ):
        if data_name not in ("coco", "flickr"):
            raise ValueError(f"data_name must be 'coco' or 'flickr', "
                             f"got {data_name!r}")
        self.data_name = data_name
        self.split = split
        if few_shot_sum is not None:
            fname = f"{data_name}_{split}_{few_shot_sum}.csv"
        else:
            fname = f"{data_name}_{split}.csv"
        self.dataset_file = os.path.join(data_root, data_name, fname)
        if image_root is None:
            if data_name == "coco":
                image_root = os.path.join(data_root, "coco")
            else:
                image_root = os.path.join(data_root, "flickr",
                                          "flickr30k-images")
        self.image_root = image_root

        self.img_id_list: List[str] = []
        self.text_id_list: List[str] = []
        self.img_dict: Dict[str, str] = {}        # img_id -> filename
        self.text_dict: Dict[str, str] = {}       # text_id -> caption
        self.img2text: Dict[str, List[str]] = {}  # img_id -> [text_id x ~5]
        self.text2img: Dict[str, str] = {}        # text_id -> img_id
        self.img2filepath: Dict[str, str] = {}    # coco only: img_id -> subdir
        self._load()

    def _load(self) -> None:
        with open(self.dataset_file, newline="") as f:
            for row in csv.reader(f):
                if not row or row[0] == "imgid":
                    continue
                if self.data_name == "coco":
                    img_id, filepath, filename, caption, sent_id = row[:5]
                    self.img2filepath.setdefault(img_id, filepath)
                else:
                    img_id, filename, caption, sent_id = row[:4]
                if img_id not in self.img_dict:
                    self.img_id_list.append(img_id)
                    self.img_dict[img_id] = filename
                    self.img2text[img_id] = []
                self.text_id_list.append(sent_id)
                self.text_dict[sent_id] = caption
                self.img2text[img_id].append(sent_id)
                self.text2img[sent_id] = img_id

    # ---- sizes -----------------------------------------------------------
    @property
    def num_images(self) -> int:
        return len(self.img_id_list)

    @property
    def num_texts(self) -> int:
        return len(self.text_id_list)

    # ---- content access --------------------------------------------------
    def image_path(self, img_id: str) -> str:
        filename = self.img_dict[img_id]
        if self.data_name == "coco":
            return os.path.join(self.image_root, self.img2filepath[img_id],
                                filename)
        return os.path.join(self.image_root, filename)

    def get_text(self, text_id: str) -> str:
        return self.text_dict[text_id]

    def get_image(self, img_id: str) -> str:
        return self.img_dict[img_id]

    def get_target(self, query_id: str, query_type: str):
        """Ground-truth relevant id(s) of a query: a text query has one
        image, an image query its list of captions."""
        if query_type == "text":
            return self.text2img[query_id]
        return self.img2text[query_id]

    # ---- example views ---------------------------------------------------
    def examples_single(self) -> List[Example]:
        """One example per image, its first caption attached."""
        out = []
        for img_id in self.img_id_list:
            text_id = self.img2text[img_id][0]
            out.append(Example(text=self.text_dict[text_id],
                               image_path=self.image_path(img_id),
                               text_id=text_id, img_id=img_id))
        return out

    def examples_full(self) -> List[Example]:
        """One example per caption."""
        out = []
        for text_id in self.text_id_list:
            img_id = self.text2img[text_id]
            out.append(Example(text=self.text_dict[text_id],
                               image_path=self.image_path(img_id),
                               text_id=text_id, img_id=img_id))
        return out

    def examples(self, mode: str) -> List[Example]:
        if mode == "single":
            return self.examples_single()
        if mode == "full":
            return self.examples_full()
        raise ValueError(f"mode must be 'single' or 'full', got {mode!r}")


def shard_examples(examples: Sequence[Example], num_shards: int,
                   shard_index: int, pad: bool = True) -> List[Example]:
    """Strided shard ``shard_index`` of ``num_shards``; with ``pad``, the
    list is first padded by repeating its head to a multiple of
    ``num_shards``, so every shard runs the same number of batches (ids
    travel with vectors, so duplicates are harmless)."""
    n = len(examples)
    if pad and n % num_shards != 0:
        padded = list(examples) + list(examples[: num_shards - n % num_shards])
    else:
        padded = list(examples)
    return padded[shard_index::num_shards]
