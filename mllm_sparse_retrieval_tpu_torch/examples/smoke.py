"""Smoke demo: encode one image and a few captions, print cosine
similarities.

The reference's manual sanity script: one forward pass per modality with
the prompt templates, the cosine similarity matrix between the image
embedding and the caption embeddings, and a peek at the top sparse terms.

Runs with the tiny family (random weights) by default; pass
``--checkpoint-path`` for a converted model.

    python -m mllm_sparse_retrieval_tpu_torch.examples.smoke \\
        --dataset flickr [--data-root DATA] [--device cuda]

``main(argv=None, model=None)`` (``model`` a built ``(params, arch,
tokenizer, template)`` on ``--device``) returns the similarities and the
two top-term lists.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    add_common_args, build_everything, mesh_from_args,
    sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.models.reps import (
    cosine_similarity_matrix)
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import encode_examples
from mllm_sparse_retrieval_tpu_torch.tools.common import checked_device


def main(argv=None, model=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = checked_device(args.device)

    if model is None:
        corpus, params, arch, tok, template, mesh, lora = \
            build_everything(args)
    else:
        from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus

        corpus = CrossModalCorpus(args.dataset, args.split, args.data_root)
        params, arch, tok, template = model
        mesh, lora = mesh_from_args(args), None
    sparse_cfg = sparse_config_from_args(args)

    image = corpus.examples_single()[:1]
    captions = corpus.examples_full()[:4]

    img = encode_examples(image, params, arch, tok, template,
                          encode_type="image", sparse_cfg=sparse_cfg,
                          batch_size=1, mesh=mesh, lora=lora, device=device)
    txt = encode_examples(captions, params, arch, tok, template,
                          encode_type="text", sparse_cfg=sparse_cfg,
                          batch_size=4, mesh=mesh, lora=lora, device=device)

    sims = cosine_similarity_matrix(
        torch.from_numpy(np.asarray(img.dense, np.float32)),
        torch.from_numpy(np.asarray(txt.dense, np.float32))).numpy()
    print(f"image {image[0].img_id} vs captions "
          f"{[c.text_id for c in captions]}")
    print("cosine similarities:", np.round(sims[0], 4).tolist())

    top_terms = sorted(img.sparse_vectors[0].items(),
                       key=lambda kv: -kv[1])[:10]
    print("top image sparse terms:", top_terms)
    top_text = sorted(txt.sparse_vectors[0].items(), key=lambda kv: -kv[1])[:10]
    print(f"caption: {captions[0].text!r}")
    print("top caption sparse terms:", top_text)
    return {"sims": sims, "image_terms": top_terms, "caption_terms": top_text}


if __name__ == "__main__":
    main()
