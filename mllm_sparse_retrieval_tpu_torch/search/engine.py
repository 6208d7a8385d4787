"""Search engine: encode queries, search the dense and impact indexes,
fuse, evaluate (the JAX package's ``search/engine.py``).

``run_search`` encodes the queries with ``encode_examples``, searches the
dense flat index and/or the impact index (the TAAT kernel on the card),
builds lazy runs (``ArrayRun``), fuses them on the host (min-max or RRF)
and computes recall@k and, on request, MRR/nDCG/MAP on the host. With
``fusion_mode="device"`` the two engines' top-k are fused on the device
(``search/device_fusion.py``); with ``eval_mode="device"`` the metrics come
from target ranks computed on the device (``eval/device_eval.py``), and no
run is copied to the host. ``impact_wire="compact48"`` brings the sparse
leg's results back in 6 bytes each instead of 8; the device-fused route
keeps the i32 wire inside the device. ``mesh=`` runs the query encode
and every search over a ``parallel.mesh.Mesh`` (data-axis sharding).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

from mllm_sparse_retrieval_tpu_torch.configs import (
    RepsLoc, SearchConfig, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.eval.device_eval import (
    build_target_arrays, dense_doc_pos, dense_eval_ranks, impact_doc_pos,
    impact_eval_ranks, metrics_from_ranks)
from mllm_sparse_retrieval_tpu_torch.eval.metrics import ranking_metrics
from mllm_sparse_retrieval_tpu_torch.eval.recall import (
    DEFAULT_KS, RecallResult, recall_at_k)
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import encode_examples
from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
    FusedHybridSearcher)
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse, fuse_rrf
from mllm_sparse_retrieval_tpu_torch.search.runs import ArrayRun, Run
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    canonical_id_map)


@dataclass
class SearchOutput:
    dense_run: Run = field(default_factory=dict)
    sparse_run: Run = field(default_factory=dict)
    fusion_run: Dict[str, Dict[str, float]] = field(default_factory=dict)
    dense_recall: Optional[RecallResult] = None
    sparse_recall: Optional[RecallResult] = None
    fusion_recall: Optional[RecallResult] = None
    # run name -> metric name -> MetricResult (run_search(metrics=...))
    extra_metrics: Dict[str, Dict[str, object]] = field(default_factory=dict)

    def summary(self) -> str:
        lines = []
        for name, rec in (("dense", self.dense_recall),
                          ("sparse", self.sparse_recall),
                          ("fusion", self.fusion_recall)):
            if rec:
                lines.append(rec.format(name))
            for metric in self.extra_metrics.get(name, {}).values():
                lines.append(metric.format(name))
        return "\n".join(lines)


# tokenizer -> {is_filtered: canonical map}; the map is an O(vocab) pass,
# constant for a tokenizer
_CMAP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _canonical_map_for(tokenizer, is_filtered: bool):
    """``canonical_id_map`` cached per (tokenizer, is_filtered)."""
    try:
        per = _CMAP_CACHE.setdefault(tokenizer, {})
    except TypeError:               # a tokenizer that takes no weak reference
        return canonical_id_map(tokenizer.get_vocab(), is_filtered)
    if is_filtered not in per:
        per[is_filtered] = canonical_id_map(tokenizer.get_vocab(),
                                            is_filtered)
    return per[is_filtered]


def _query_cmap(impact_index, tokenizer, sparse_cfg):
    """The canonical map queries must use for this index: the one it was
    built with (``query_canonical``), else none."""
    if getattr(impact_index, "query_canonical", False):
        return _canonical_map_for(tokenizer, sparse_cfg.is_filtered)
    return None


def _encode_sparse_queries(impact_index, enc, tokenizer, sparse_cfg):
    """Padded (term_idx, weight) query arrays for ``search_encoded``: the
    id-keyed route for an int-keyed index (no string round trip), else the
    string-dict route; the same arrays ``search_terms`` / ``search``
    build."""
    if impact_index.int_keyed and enc.selected_terms:
        cmap = _query_cmap(impact_index, tokenizer, sparse_cfg)
        return impact_index.encode_query_terms(enc.selected_terms, cmap)
    return impact_index.encode_queries(enc.query_weights)


def run_search(
    queries: Sequence[Example],
    params,
    arch,
    tokenizer,
    template,
    *,
    query_type: str,                       # 'text' | 'image'
    sparse_cfg: SparseConfig,
    search_cfg: SearchConfig,
    dense_index: Optional[DenseFlatIndex] = None,
    impact_index: Optional[ImpactIndex] = None,
    reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
    batch_size: int = 8,
    lora=None,
    pixel_loader: Optional[Callable] = None,
    get_target: Optional[Callable[[str], object]] = None,
    ks: Sequence[int] = DEFAULT_KS,
    impact_backend: str = "auto",
    impact_wire: str = "i32",
    fusion_mode: str = "host",
    fusion_rule: str = "minmax",
    metrics: Sequence[str] = (),
    eval_mode: str = "host",
    device="cuda",
    mesh=None,
) -> SearchOutput:
    """Encode queries on ``device`` and search the given indexes.

    With both indexes the runs are fused: ``fusion_mode="host"`` fuses the
    dense and sparse runs in Python, ``fusion_rule`` ``"minmax"`` (the
    reference's weighted min-max sum, weights ``alpha`` / ``1 - alpha``)
    or ``"rrf"``; ``fusion_mode="device"`` fuses both engines' top-k on
    the device under the min-max rule and fills only ``fusion_run`` and
    ``fusion_recall`` (the top ``depth`` fused docs of each query, which
    give the host route's recall@k for every k <= depth).
    ``get_target`` (query id -> relevant id or ids) enables recall@``ks``
    and the ``metrics`` (``"mrr"``, ``"ndcg"``, ``"map"``); without it only
    the runs are made. ``eval_mode="device"`` computes them from target
    ranks on the device and fills no run. ``impact_wire="compact48"``
    brings the host routes' sparse results back on the 6-byte wire
    (integer weights only); the device routes never copy the sparse run,
    so they keep the i32 wire. ``mesh`` (a ``parallel.mesh.Mesh``)
    encodes the queries with their batches split over its data axis and
    shards both indexes over it; it replaces ``device``.
    """
    if fusion_mode not in ("host", "device"):
        raise ValueError(f"fusion_mode must be 'host' or 'device', "
                         f"got {fusion_mode!r}")
    if eval_mode not in ("host", "device"):
        raise ValueError(f"eval_mode must be 'host' or 'device', "
                         f"got {eval_mode!r}")
    if eval_mode == "device":
        if get_target is None:
            raise ValueError("eval_mode='device' computes metrics on "
                             "device — it requires get_target")
        if dense_index is not None and impact_index is not None \
                and fusion_mode != "device":
            raise ValueError(
                "eval_mode='device' with BOTH indexes requires "
                "fusion_mode='device' (host min-max fusion materializes "
                "both runs on host, which is exactly the fetch this mode "
                "eliminates)")
    if fusion_rule not in ("minmax", "rrf"):
        raise ValueError(f"fusion_rule must be 'minmax' or 'rrf', "
                         f"got {fusion_rule!r}")
    if fusion_rule == "rrf" and fusion_mode == "device":
        raise ValueError("fusion_rule='rrf' is host-path only (the "
                         "device-fused program implements the min-max rule)")
    if fusion_mode == "device" and (dense_index is None
                                    or impact_index is None):
        raise ValueError("fusion_mode='device' needs BOTH a dense and an "
                         "impact index (it is the hybrid serving path)")
    if impact_wire not in ("i32", "compact48"):
        raise ValueError(f"impact_wire must be 'i32' or 'compact48', "
                         f"got {impact_wire!r}")
    out = SearchOutput()

    enc = encode_examples(
        queries, params, arch, tokenizer, template,
        encode_type=query_type, sparse_cfg=sparse_cfg, reps_loc=reps_loc,
        batch_size=batch_size, is_query=True, lora=lora,
        pixel_loader=pixel_loader, device=device, mesh=mesh)

    if eval_mode == "device":
        return _device_eval(out, enc, tokenizer, sparse_cfg, search_cfg,
                            dense_index, impact_index, get_target, ks,
                            impact_backend, fusion_mode, metrics, mesh)

    if fusion_mode == "device":
        q_idx, q_w = _encode_sparse_queries(impact_index, enc, tokenizer,
                                            sparse_cfg)
        searcher = FusedHybridSearcher(dense_index, impact_index,
                                       alpha=search_cfg.alpha, mesh=mesh,
                                       backend=impact_backend)
        out.fusion_run = searcher.search_run(
            enc.dense, q_idx, q_w, enc.ids, search_cfg.depth,
            remove_query=search_cfg.remove_query)
        if get_target is not None:
            out.fusion_recall = recall_at_k(out.fusion_run, get_target, ks)
            if metrics:
                out.extra_metrics["fusion"] = ranking_metrics(
                    out.fusion_run, get_target, ks, which=tuple(metrics))
        return out

    if dense_index is not None:
        scores, id_rows = dense_index.search_ids(
            enc.dense, search_cfg.depth,
            batch_size=max(search_cfg.batch_size, 1), mesh=mesh)
        out.dense_run = ArrayRun(enc.ids, scores.tolist(), id_rows,
                                 remove_query=search_cfg.remove_query,
                                 scores_sorted=True)

    if impact_index is not None:
        q_idx, q_w = _encode_sparse_queries(impact_index, enc, tokenizer,
                                            sparse_cfg)
        s_scores, s_ids = impact_index.search_encoded(
            q_idx, q_w, search_cfg.depth, mesh=mesh, backend=impact_backend,
            wire=impact_wire)
        out.sparse_run = ArrayRun(enc.ids, s_scores, s_ids,
                                  remove_query=search_cfg.remove_query,
                                  scores_sorted=True)

    if dense_index is not None and impact_index is not None:
        fuse_fn = fuse_rrf if fusion_rule == "rrf" else fuse
        out.fusion_run = fuse_fn([out.dense_run, out.sparse_run],
                                 [search_cfg.alpha, 1.0 - search_cfg.alpha])

    if get_target is not None:
        for name, run in (("dense", out.dense_run),
                          ("sparse", out.sparse_run),
                          ("fusion", out.fusion_run)):
            if not run:
                continue
            setattr(out, f"{name}_recall", recall_at_k(run, get_target, ks))
            if metrics:
                out.extra_metrics[name] = ranking_metrics(
                    run, get_target, ks, which=tuple(metrics))
    return out


def _device_eval(out: SearchOutput, enc, tokenizer, sparse_cfg, search_cfg,
                 dense_index, impact_index, get_target, ks, impact_backend,
                 fusion_mode, metrics, mesh=None) -> SearchOutput:
    """``eval_mode="device"``: recall (and the requested metrics) from
    target ranks computed on the device. No run is copied to the host, so
    the run dicts of ``SearchOutput`` stay empty; the values equal the host
    consumers' on the same device output (``eval/device_eval.py``)."""
    which = tuple(metrics)
    if fusion_mode == "device":
        q_idx, q_w = _encode_sparse_queries(impact_index, enc, tokenizer,
                                            sparse_cfg)
        tgt, ntg, _ = build_target_arrays(enc.ids, get_target,
                                          dense_doc_pos(dense_index))
        searcher = FusedHybridSearcher(dense_index, impact_index,
                                       alpha=search_cfg.alpha, mesh=mesh,
                                       backend=impact_backend)
        ranks = searcher.eval_ranks(
            enc.dense, q_idx, q_w, tgt, search_cfg.depth,
            qids=enc.ids if search_cfg.remove_query else None)
        out.fusion_recall, extras = metrics_from_ranks(enc.ids, ranks, ntg,
                                                       ks, which)
        if which:
            out.extra_metrics["fusion"] = extras
        return out

    if dense_index is not None:
        tgt, ntg, selfp = build_target_arrays(
            enc.ids, get_target, dense_doc_pos(dense_index),
            remove_query=search_cfg.remove_query)
        ranks = dense_eval_ranks(dense_index, enc.dense, tgt, selfp,
                                 search_cfg.depth,
                                 batch_size=max(search_cfg.batch_size, 1),
                                 mesh=mesh)
        out.dense_recall, extras = metrics_from_ranks(enc.ids, ranks, ntg,
                                                      ks, which)
        if which:
            out.extra_metrics["dense"] = extras

    if impact_index is not None:
        q_idx, q_w = _encode_sparse_queries(impact_index, enc, tokenizer,
                                            sparse_cfg)
        tgt, ntg, selfp = build_target_arrays(
            enc.ids, get_target, impact_doc_pos(impact_index),
            remove_query=search_cfg.remove_query)
        ranks = impact_eval_ranks(impact_index, q_idx, q_w, tgt, selfp,
                                  search_cfg.depth, mesh=mesh,
                                  backend=impact_backend)
        out.sparse_recall, extras = metrics_from_ranks(enc.ids, ranks, ntg,
                                                       ks, which)
        if which:
            out.extra_metrics["sparse"] = extras
    return out
