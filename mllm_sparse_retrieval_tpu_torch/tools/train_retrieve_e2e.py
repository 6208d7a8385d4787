"""Full training-loop system check: few-shot contrastive LoRA training must
IMPROVE retrieval, end to end, at the reference recipe's scale.

Runs the reference's few-shot recipe shape (the ``{dataset}_train_{N}.csv``
200-image split in mode ``single``: ONE caption per image, so no batch
holds two captions of one image, which would poison the in-batch InfoNCE
targets; LoRA r=8, alpha 16, tau 0.05) on the tiny family, then encodes
the split's image corpus and caption queries with the BEFORE and AFTER
weights, builds dense and impact indexes, and reports t2i recall@{1,5,10}
for both. Pixels are seeded per image id, so the caption-image pairing is
learnable: the trained model must beat the random-init one by a wide
margin on the SEEN captions. Recall over all captions (the unseen ones
need a pretrained model's language understanding) is printed, not gated.
This checks the whole loop (collation, trainer, LoRA merge, encode, both
indexes, fusion, recall) short of real checkpoint weights.

    python -m mllm_sparse_retrieval_tpu_torch.tools.train_retrieve_e2e \\
        [--dataset flickr] [--few-shot 200] [--epochs 24] \\
        [--batch-size 16] [--lr 3e-3] [--depth 10] [--mesh] [--device cuda]

Exits 1 if the trained seen-caption fusion recall@1 fails to beat the
untrained model's by at least --min-lift (default 0.3).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import checked_device


def evaluate(tag, params, arch, tok, template, examples, images, depth,
             batch_size, mesh, get_target, device):
    """Encode ``images`` as the corpus, index both ways and search
    ``examples``' captions: a ``SearchOutput``."""
    from mllm_sparse_retrieval_tpu_torch.configs import (SearchConfig,
                                                         SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples)
    from mllm_sparse_retrieval_tpu_torch.search.engine import run_search

    scfg = SparseConfig()
    t0 = time.time()
    img_enc = encode_examples(images, params, arch, tok, template,
                              encode_type="image", sparse_cfg=scfg,
                              batch_size=batch_size, mesh=mesh, device=device)
    dense = DenseFlatIndex(device=device)
    dense.add(img_enc.dense, img_enc.ids)
    imp = ImpactIndex(device=device)
    for i, v in zip(img_enc.ids, img_enc.sparse_vectors):
        imp.add(i, v)
    imp.finalize()
    out = run_search(examples, params, arch, tok, template,
                     query_type="text", sparse_cfg=scfg,
                     search_cfg=SearchConfig(depth=depth, alpha=0.5),
                     dense_index=dense, impact_index=imp,
                     batch_size=batch_size, mesh=mesh,
                     get_target=get_target, device=device)
    print(f"[{tag}] ({time.time() - t0:.0f}s)", flush=True)
    print(out.summary(), flush=True)
    return out


def main(argv=None, model=None):
    """Run the check; ``model`` is the tiny family's ``(params, arch,
    tokenizer, template)`` on ``--device``, else it is drawn from seed 0.
    Returns the exit code: 0, or 1 below ``--min-lift``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="flickr", choices=["coco", "flickr"])
    ap.add_argument("--data-root", default="/root/reference/data")
    ap.add_argument("--few-shot", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=24,
                    help="the recipe trains 5 epochs on a pretrained 8B; "
                         "the random-init tiny model needs more passes to "
                         "memorize (200 images / batch 16 = 12 steps an "
                         "epoch)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="the recipe uses 5e-5 for 8B models; the tiny "
                         "model needs a larger step to converge in minutes")
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--min-lift", type=float, default=0.3)
    ap.add_argument("--limit-images", type=int, default=0,
                    help="slice the split to the first N images "
                         "(test-speed knob; 0 = the whole split)")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelConfig, ModelFamily, TrainConfig)
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.models import build_model
    from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib
    from mllm_sparse_retrieval_tpu_torch.train.trainer import (
        ContrastiveTrainer, make_collator)

    t_start = time.time()
    corpus = CrossModalCorpus(args.dataset, "train", args.data_root,
                              few_shot_sum=args.few_shot)
    # one caption per image (the reference trains mode 'single'): every
    # in-batch negative is a distinct image
    examples = corpus.examples("single")
    if args.limit_images:
        examples = examples[:args.limit_images]
        keep = {e.img_id for e in examples}
    images = examples
    full_captions = [e for e in corpus.examples("full")
                     if not args.limit_images or e.img_id in keep]
    target = {e.text_id: e.img_id for e in full_captions}
    print(f"few-shot split: {len(examples)} train pairs / "
          f"{len(full_captions)} total captions (device={device})",
          flush=True)

    if model is None:
        cfg = ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32",
                          tiny_vocab_size=2048, tiny_hidden_size=128)
        model = build_model(cfg, captions=[e.text for e in examples],
                            device=device)
    params, arch, tok, template = model
    mesh = None
    if args.mesh:
        from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
        mesh = make_mesh(devices=None if device.type == "cuda" else [device])
    common = (args.depth, args.batch_size, mesh, target.__getitem__, device)

    before = evaluate("before training (random init)", params, arch, tok,
                      template, examples, images, *common)

    # the reference recipe's shape: LoRA r=8 alpha=16, tau=0.05
    tcfg = TrainConfig(learning_rate=args.lr, tau=0.05, lora_rank=8,
                       lora_alpha=16, num_epochs=args.epochs,
                       shard_optimizer_state=mesh is not None)
    adapters = lora_lib.init_lora(
        torch.Generator(device=device).manual_seed(0), params, arch,
        rank=tcfg.lora_rank, alpha=tcfg.lora_alpha, train_projector=True,
        device=device)
    trainer = ContrastiveTrainer(params, arch, adapters, tcfg, mesh=mesh,
                                 device=device)
    collate = make_collator(tok, template, arch)
    t0 = time.time()
    losses = trainer.train(examples, collate, batch_size=args.batch_size,
                           num_epochs=args.epochs, logger=None)
    print(f"trained {args.epochs} epochs in {time.time() - t0:.0f}s: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps)", flush=True)

    merged = trainer.merged_params()
    after = evaluate("after training (LoRA merged), seen captions", merged,
                     arch, tok, template, examples, images, *common)
    # all captions of each image: the unseen ones need caption semantics
    # a random-init model lacks; printed, not gated
    evaluate("after training, ALL captions (generalization, informational)",
             merged, arch, tok, template, full_captions, images, *common)

    b1 = before.fusion_recall[1]
    a1 = after.fusion_recall[1]
    lift = a1 - b1
    print(f"\nseen-caption fusion recall@1: {b1:.3f} -> {a1:.3f} "
          f"(lift {lift:+.3f}); "
          f"dense {before.dense_recall[1]:.3f} -> "
          f"{after.dense_recall[1]:.3f}; sparse "
          f"{before.sparse_recall[1]:.3f} -> {after.sparse_recall[1]:.3f}",
          flush=True)
    print(f"TRAIN->RETRIEVE E2E DONE in {time.time() - t_start:.0f}s",
          flush=True)
    if lift < args.min_lift:
        print(f"FAIL: recall@1 lift {lift:.3f} < {args.min_lift}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
