"""Real-weights recall runbook: one command between a converted checkpoint
and the filled BASELINE.md "Measured" table.

Encodes the caption and image corpora, builds dense and impact indexes over
BOTH sides, runs both retrieval directions (t2i: text queries -> image
corpus; i2t: image queries -> caption corpus) through dense, sparse and
hybrid-fusion scoring, and prints markdown rows with R@{1,5,10}, search-only
QPS and index build times. The recipe is the reference's: depth 1,000,
alpha 0.5.

    python -m mllm_sparse_retrieval_tpu_torch.tools.reproduce_recall \\
        --family llava_1_5 --checkpoint-path /mnt/ckpt_converted \\
        --image-root /mnt/flickr30k-images --dataset flickr \\
        [--depth 1000] [--alpha 0.5] [--batch-size 8] [--mesh] \\
        [--device cuda] [--out /tmp/recall_rows.md]

The checkpoint directory is ``models/convert.convert_hf_dir``'s output.
Without ``--checkpoint-path`` the tool runs the tiny family on seeded
pixels (recall near random), which keeps the runbook runnable without
weights. Each timed window ends on results in host memory, so a QPS counts
finished work. The hardware column is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import time

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, sync)


def build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="flickr", choices=["coco", "flickr"])
    ap.add_argument("--data-root", default="/root/reference/data")
    ap.add_argument("--split", default="test")
    ap.add_argument("--family", default="tiny_debug")
    ap.add_argument("--checkpoint-path", default=None,
                    help="converted checkpoint dir (params.pkl + arch.json)")
    ap.add_argument("--lora-path", default=None)
    ap.add_argument("--image-root", default=None,
                    help="directory of the dataset's real images")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=1000,
                    help="retrieval depth (the reference's search recipe)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sparse-length", type=int, default=128)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--impact-backend", default="auto")
    ap.add_argument("--limit-captions", type=int, default=0,
                    help="dry-run cap (0 = full corpus)")
    ap.add_argument("--limit-images", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the markdown rows to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    return ap.parse_args(argv)


def _encode_side(examples, params, arch, tok, tmpl, *, encode_type,
                 sparse_cfg, batch_size, mesh, lora, is_query, device):
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples)

    t0 = time.time()
    enc = encode_examples(examples, params, arch, tok, tmpl,
                          encode_type=encode_type, sparse_cfg=sparse_cfg,
                          batch_size=batch_size, mesh=mesh, lora=lora,
                          is_query=is_query, device=device)
    dt = time.time() - t0
    print(f"  encode {encode_type} x{len(examples)} "
          f"({'query' if is_query else 'corpus'}): {dt:.1f}s "
          f"({len(examples) / dt:.1f}/s)", flush=True)
    return enc


def _build_indexes(enc, mesh, device):
    from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex

    t0 = time.time()
    dense = DenseFlatIndex(device=device)
    dense.add(enc.dense, enc.ids)
    dense._materialize(mesh=mesh)
    sync(device)
    t_dense = time.time() - t0

    t0 = time.time()
    imp = ImpactIndex(device=device)
    for i, v in zip(enc.ids, enc.sparse_vectors):
        imp.add(i, v)
    imp.finalize()
    t_sparse = time.time() - t0
    print(f"  index build: dense {t_dense:.1f}s, impact {t_sparse:.1f}s "
          f"({imp.num_docs} docs / {imp.num_terms} terms)", flush=True)
    return dense, imp, t_dense, t_sparse


def _search_direction(direction, q_enc, dense, imp, targets, args, mesh):
    """Search pre-encoded queries; returns {config: (RecallResult, qps)}."""
    from mllm_sparse_retrieval_tpu_torch.eval.recall import recall_at_k
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.search.runs import make_run

    depth = min(args.depth, dense.size)
    ks = [k for k in (1, 5, 10) if k <= depth]
    out = {}

    t0 = time.time()
    d_scores, d_ids = dense.search_ids(
        q_enc.dense, depth, batch_size=max(args.batch_size, 1), mesh=mesh)
    t_dense = time.time() - t0
    dense_run = make_run(q_enc.ids, d_scores.tolist(), d_ids)
    out["dense"] = (recall_at_k(dense_run, targets, ks),
                    len(q_enc.ids) / t_dense)

    t0 = time.time()
    s_scores, s_ids = imp.search(q_enc.query_weights, depth, mesh=mesh,
                                 backend=args.impact_backend)
    t_sparse = time.time() - t0
    sparse_run = make_run(q_enc.ids, s_scores, s_ids)
    out["sparse"] = (recall_at_k(sparse_run, targets, ks),
                     len(q_enc.ids) / t_sparse)

    t0 = time.time()
    fusion_run = fuse([dense_run, sparse_run], [args.alpha, 1.0 - args.alpha])
    t_fuse = time.time() - t0
    out[f"hybrid a={args.alpha}"] = (
        recall_at_k(fusion_run, targets, ks),
        len(q_enc.ids) / (t_dense + t_sparse + t_fuse))

    for name, (rec, qps) in out.items():
        print(f"  {direction} {name}: {rec.format()}  [{qps:.0f} QPS]",
              flush=True)
    return out


def format_rows(dataset_label, results, build_times, hw):
    """BASELINE.md Measured-table markdown rows, ready to paste."""
    lines = ["| Config | Dataset | Direction | R@1 | R@5 | R@10 | QPS | "
             "Index build | Notes |",
             "|---|---|---|---|---|---|---|---|---|"]
    for config in results["t2i"]:
        for direction in ("t2i", "i2t"):
            rec, qps = results[direction][config]
            cell = lambda k: f"{rec.recalls[k]:.4f}" if k in rec.recalls \
                else "—"  # cutoff above corpus size (dry-run subsets)
            build = build_times["image" if direction == "t2i" else "caption"]
            lines.append(
                f"| {config} | {dataset_label} | {direction} "
                f"| {cell(1)} | {cell(5)} | {cell(10)} | {qps:.0f} "
                f"| {build} | {hw}, search-only QPS (queries pre-encoded) |")
    return "\n".join(lines)


def main(argv=None, model=None):
    """Run the runbook; ``model`` is ``(params, arch, tokenizer, template)``
    on ``--device``, else the family is built (or loaded from
    ``--checkpoint-path``). Returns ``{direction: {config: (RecallResult,
    qps)}}``."""
    args = build_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelConfig, ModelFamily, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.models import build_model
    from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib

    t_start = time.time()
    corpus = CrossModalCorpus(args.dataset, args.split, args.data_root,
                              image_root=args.image_root)
    captions = corpus.examples("full")
    images = corpus.examples("single")
    if args.limit_captions:
        captions = captions[: args.limit_captions]
        keep = {e.img_id for e in captions}
        images = [e for e in images if e.img_id in keep]
    if args.limit_images:
        images = images[: args.limit_images]
    have_images = bool(images) and os.path.exists(images[0].image_path)
    hw = hardware(device)
    print(f"corpus: {len(captions)} captions, {len(images)} images, "
          f"real pixels: {have_images} (device={device}, {hw})", flush=True)
    if not have_images:
        print("  WARNING: image files not found — synthetic pixels; "
              "recall will be near random (dry-run mode)", flush=True)

    if model is None:
        family = ModelFamily(args.family)
        tiny_kw = dict(tiny_vocab_size=2048, tiny_hidden_size=128) \
            if family == ModelFamily.TINY_DEBUG else {}
        cfg = ModelConfig(family=family, checkpoint_path=args.checkpoint_path,
                          lora_path=args.lora_path, dtype=args.dtype,
                          **tiny_kw)
        model = build_model(cfg, captions=[e.text for e in captions],
                            device=device)
    params, arch, tok, tmpl = model
    lora = lora_lib.load_lora(args.lora_path, device) if args.lora_path \
        else None
    mesh = None
    if args.mesh:
        from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
        mesh = make_mesh(devices=None if device.type == "cuda" else [device])
    sp = SparseConfig(sparse_length=args.sparse_length)
    side = dict(sparse_cfg=sp, batch_size=args.batch_size, mesh=mesh,
                lora=lora, device=device)

    print("== corpus encode + index build ==", flush=True)
    cap_enc = _encode_side(captions, params, arch, tok, tmpl,
                           encode_type="text", is_query=False, **side)
    cap_dense, cap_imp, cd_t, cs_t = _build_indexes(cap_enc, mesh, device)
    img_enc = _encode_side(images, params, arch, tok, tmpl,
                           encode_type="image", is_query=False, **side)
    img_dense, img_imp, id_t, is_t = _build_indexes(img_enc, mesh, device)

    print("== query encode ==", flush=True)
    cap_q = _encode_side(captions, params, arch, tok, tmpl,
                         encode_type="text", is_query=True, **side)
    img_q = _encode_side(images, params, arch, tok, tmpl,
                         encode_type="image", is_query=True, **side)

    print("== search ==", flush=True)
    results = {
        "t2i": _search_direction(
            "t2i", cap_q, img_dense, img_imp,
            lambda qid: corpus.get_target(qid, "text"), args, mesh),
        "i2t": _search_direction(
            "i2t", img_q, cap_dense, cap_imp,
            lambda qid: corpus.get_target(qid, "image"), args, mesh),
    }

    label = {"flickr": "Flickr-1K", "coco": "COCO-5K"}[args.dataset]
    if args.limit_captions or args.limit_images:
        label += f" (subset {len(captions)}c/{len(images)}i)"
    build_times = {
        "caption": f"dense {cd_t:.1f}s + impact {cs_t:.1f}s",
        "image": f"dense {id_t:.1f}s + impact {is_t:.1f}s",
    }
    table = format_rows(label, results, build_times, hw)
    print("\n== BASELINE.md Measured rows (paste-ready) ==", flush=True)
    print(table, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
        print(f"written to {args.out}", flush=True)
    print(f"\nREPRODUCE RECALL DONE in {time.time() - t_start:.0f}s",
          flush=True)

    # invariants that hold with any weights: every direction and config
    # ranked its queries
    for direction in ("t2i", "i2t"):
        for config, (rec, _) in results[direction].items():
            if rec.num_queries <= 0:
                raise RuntimeError(f"{direction}/{config}: empty run")
    return results


if __name__ == "__main__":
    main()
