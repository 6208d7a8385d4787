"""PyTorch port: ``data/karpathy.py`` (``CrossModalCorpus``,
``shard_examples``) against the JAX package's on CSVs this file writes,
in both layouts (coco with ``filepath``, flickr without), with seeded
captions, duplicate-id rows, a header, blank lines and a few-shot file.

Tolerance: exact. Every list, map, path, example and shard must be equal.
"""

import csv

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.data.karpathy import (
    CrossModalCorpus as JCorpus, shard_examples as j_shard_examples)
from mllm_sparse_retrieval_tpu_torch.configs import DataConfig, SearchConfig
from mllm_sparse_retrieval_tpu_torch.data import (
    CrossModalCorpus, Example, shard_examples)

WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball"]


def write_corpus(root, name, split, seed, n_images=7, suffix=""):
    """A Karpathy CSV under ``root/name``: ``n_images`` images with 4-6
    seeded captions each (ids shuffled so file order is not id order), a
    header line and a blank line."""
    rng = np.random.default_rng(seed)
    rows, sent = [], 1000 * seed
    for img in rng.permutation(np.arange(100, 100 + n_images)):
        for _ in range(int(rng.integers(4, 7))):
            cap = "a " + " ".join(rng.choice(WORDS, size=int(
                rng.integers(3, 7))))
            fname = f"img{img}.jpg"
            rows.append([str(img), f"val{img % 3}", fname, cap, str(sent)]
                        if name == "coco" else
                        [str(img), fname, cap, str(sent)])
            sent += 1
    order = rng.permutation(len(rows))
    header = (["imgid", "filepath", "filename", "caption", "sentid"]
              if name == "coco" else ["imgid", "filename", "caption",
                                      "sentid"])
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    with open(d / f"{name}_{split}{suffix}.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in order:
            w.writerow(rows[i])
        f.write("\n")
    return len(rows)


def _same(a, b):
    for attr in ("data_name", "split", "dataset_file", "image_root",
                 "img_id_list", "text_id_list", "img_dict", "text_dict",
                 "img2text", "text2img", "img2filepath", "num_images",
                 "num_texts"):
        assert getattr(a, attr) == getattr(b, attr), attr


def _examples_equal(got, want):
    assert [type(e) for e in got] == [Example] * len(want)
    assert [(e.text, e.image_path, e.text_id, e.img_id) for e in got] == \
        [(e.text, e.image_path, e.text_id, e.img_id) for e in want]


@pytest.mark.parametrize("name", ["coco", "flickr"])
def test_corpus_matches_jax(tmp_path, name):
    n_rows = write_corpus(tmp_path, name, "test", seed=3)
    got = CrossModalCorpus(name, "test", str(tmp_path))
    want = JCorpus(name, "test", str(tmp_path))
    _same(got, want)
    assert got.num_texts == n_rows
    for mode in ("single", "full"):
        _examples_equal(got.examples(mode), want.examples(mode))
    _examples_equal(got.examples_single(), want.examples_single())
    _examples_equal(got.examples_full(), want.examples_full())
    for img_id in got.img_id_list:
        assert got.image_path(img_id) == want.image_path(img_id)
        assert got.get_image(img_id) == want.get_image(img_id)
        assert got.get_target(img_id, "image") == \
            want.get_target(img_id, "image")
    for text_id in got.text_id_list:
        assert got.get_text(text_id) == want.get_text(text_id)
        assert got.get_target(text_id, "text") == \
            want.get_target(text_id, "text")
    if name == "coco":
        ex = got.examples_single()[0]
        assert ex.image_path == str(tmp_path / "coco" /
                                    got.img2filepath[ex.img_id] /
                                    got.img_dict[ex.img_id])
    else:
        assert got.image_root == str(tmp_path / "flickr" /
                                     "flickr30k-images")


@pytest.mark.parametrize("name", ["coco", "flickr"])
def test_few_shot_file_and_image_root(tmp_path, name):
    write_corpus(tmp_path, name, "train", seed=4)
    write_corpus(tmp_path, name, "train", seed=5, n_images=3,
                 suffix="_200")
    full = CrossModalCorpus(name, "train", str(tmp_path))
    few = CrossModalCorpus(name, "train", str(tmp_path), few_shot_sum=200,
                           image_root="/images")
    want = JCorpus(name, "train", str(tmp_path), few_shot_sum=200,
                   image_root="/images")
    _same(few, want)
    assert few.dataset_file.endswith(f"{name}_train_200.csv")
    assert few.num_images == 3 and full.num_images == 7
    assert few.image_root == "/images"
    _examples_equal(few.examples_full(), want.examples_full())


def test_corpus_rejects_what_the_jax_one_rejects(tmp_path):
    with pytest.raises(ValueError, match="coco.*flickr"):
        CrossModalCorpus("mscoco", "test", str(tmp_path))
    write_corpus(tmp_path, "flickr", "test", seed=6)
    c = CrossModalCorpus("flickr", "test", str(tmp_path))
    with pytest.raises(ValueError, match="single.*full"):
        c.examples("pairs")
    with pytest.raises(FileNotFoundError):
        CrossModalCorpus("flickr", "val", str(tmp_path))


@pytest.mark.parametrize("n,shards,pad", [(17, 4, True), (17, 4, False),
                                          (16, 4, True), (5, 8, True),
                                          (3, 1, True)])
def test_shard_examples_matches_jax(tmp_path, n, shards, pad):
    write_corpus(tmp_path, "flickr", "test", seed=7, n_images=6)
    ex = CrossModalCorpus("flickr", "test", str(tmp_path)).examples_full()
    ex = ex[:n]
    jex = JCorpus("flickr", "test", str(tmp_path)).examples_full()[:n]
    for i in range(shards):
        _examples_equal(shard_examples(ex, shards, i, pad),
                        j_shard_examples(jex, shards, i, pad))
    if pad:
        sizes = {len(shard_examples(ex, shards, i)) for i in range(shards)}
        assert len(sizes) == 1


def test_data_and_search_configs_match_jax():
    import dataclasses

    from mllm_sparse_retrieval_tpu import configs as jconfigs

    for ours, theirs in ((DataConfig, jconfigs.DataConfig),
                         (SearchConfig, jconfigs.SearchConfig)):
        got = [(f.name, f.default) for f in dataclasses.fields(ours)]
        want = [(f.name, f.default) for f in dataclasses.fields(theirs)]
        assert got == want
