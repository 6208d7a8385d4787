"""Hybrid dense + sparse search fused on the device, one copy to the host
per chunk (the JAX package's ``search/device_fusion.py``, one device).

``FusedHybridSearcher`` drives both engines chunk by chunk through the
dispatch-ahead pipeline (``ops/stream.py``): per chunk it enqueues the
impact scoring and top-k (the TAAT kernel on the card), the dense MIPS and
its top-k, and the fusion (``ops/hybrid_fusion.py``), with no host sync
between them, and the host copies one packed ``[B, 2 * out_depth]`` fused
result. The host route (``search/engine.run_search``, ``fusion_mode=
"host"``) copies two depth-sized runs instead and fuses them in Python;
the fused scores agree with its ``search.fusion.fuse`` to f32 rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.ops.hybrid_fusion import (
    fused_topk_packed)
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk
from mllm_sparse_retrieval_tpu_torch.ops.stream import pipeline_dispatch
from mllm_sparse_retrieval_tpu_torch.search.runs import Run


def _canonical(device) -> torch.device:
    """One spelling per device: ``cpu:0`` is ``cpu``, and a CUDA device
    with no index is the current one (``cuda`` is ``cuda:0`` there)."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class FusedHybridSearcher:
    """Hybrid dense + sparse retrieval with the runs fused on the device.

    Both indexes must cover one corpus (every impact doc id in the dense
    index) and live on one device; construction raises otherwise. The doc
    permutation is built once, so growing either index afterwards makes
    every search raise: build a fresh searcher.
    """

    def __init__(self, dense_index: DenseFlatIndex,
                 impact_index: ImpactIndex, alpha: float = 0.5, mesh=None,
                 backend: str = "auto"):
        if mesh is not None:
            raise NotImplementedError(
                "the port's hybrid search runs on one device: meshes wait "
                "for sharding (ROADMAP Queue 1 #9)")
        if _canonical(dense_index.device) != _canonical(impact_index.device):
            raise ValueError(f"the dense index is on {dense_index.device}, "
                             f"the impact index on {impact_index.device}; "
                             f"hybrid fusion needs one device")
        self.dense = dense_index
        self.impact = impact_index
        self.alpha = float(alpha)
        self.backend = backend
        self.device = impact_index.device
        # impact-local doc order -> dense-local doc order, once per pair
        dense_pos = {d: i for i, d in enumerate(dense_index.lookup)}
        self._dense_pos = dense_pos
        perm = np.full(max(len(impact_index.doc_ids), 1), -1, np.int32)
        missing = []
        for i, d in enumerate(impact_index.doc_ids):
            p = dense_pos.get(d)
            if p is None:
                missing.append(d)
            else:
                perm[i] = p
        if missing:
            raise ValueError(
                f"{len(missing)} impact docs absent from the dense index "
                f"(first: {missing[:3]}); hybrid fusion requires one corpus")
        self._perm_host = perm
        self._perm_dev: Optional[torch.Tensor] = None
        self._lookup_arr = np.asarray(dense_index.lookup)
        self._w_dense = torch.tensor(self.alpha, dtype=torch.float32,
                                     device=self.device)
        self._w_sparse = torch.tensor(1.0 - self.alpha, dtype=torch.float32,
                                      device=self.device)
        self._n_dense = len(dense_index.lookup)
        self._n_impact = len(impact_index.doc_ids)

    def _check_fresh(self) -> None:
        if (len(self.dense.lookup) != self._n_dense
                or len(self.impact.doc_ids) != self._n_impact):
            raise RuntimeError(
                "index membership changed after FusedHybridSearcher "
                "construction (dense "
                f"{self._n_dense}->{len(self.dense.lookup)}, impact "
                f"{self._n_impact}->{len(self.impact.doc_ids)}); build a "
                "fresh searcher — the doc permutation is cached at init")

    # ---- internals -----------------------------------------------------------
    def _self_indices(self, qids: Optional[Sequence[str]], n: int
                      ) -> np.ndarray:
        if qids is None:
            return np.full(n, -1, np.int32)
        return np.fromiter((self._dense_pos.get(str(q), -1) for q in qids),
                           np.int32, count=n)

    def _dispatch_fused(self, plan, chunk_i, chunk_w, dense_chunk,
                        self_chunk, out_k: int) -> torch.Tensor:
        """Enqueue the impact search, the dense search and the fusion of
        one chunk; returns the fused packed device tensor, no host sync.
        Each stage is a profiler range (``impact_search``, ``dense_search``,
        ``fusion``)."""
        with record_function("impact_search"):
            sparse_packed = self.impact._dispatch_encoded(plan, chunk_i,
                                                          chunk_w)
        with record_function("dense_search"):
            dense_packed = self.dense._dispatch_chunk(dense_chunk, plan["k"])
        with record_function("fusion"):
            if self._perm_dev is None:
                self._perm_dev = torch.from_numpy(self._perm_host).to(
                    self.device)
            self_dev = torch.from_numpy(self_chunk).to(self.device)
            return fused_topk_packed(sparse_packed, dense_packed,
                                     self._perm_dev, self_dev, self._w_dense,
                                     self._w_sparse, out_k)

    def _resolve_fused(self, packed: torch.Tensor, take: int
                       ) -> Tuple[List[List[float]], List[List[str]]]:
        scores, idx = unpack_topk(packed[:take].cpu().numpy())
        ids_rows = self._lookup_arr[np.clip(idx, 0,
                                            len(self._lookup_arr) - 1)]
        out_scores = scores.tolist()
        out_ids = ids_rows.tolist()
        # -inf marks rows whose union held fewer than out_k docs
        if scores.size and not np.isfinite(scores.min()):
            for row in np.nonzero((~np.isfinite(scores)).any(axis=1))[0]:
                keep = np.isfinite(scores[row])
                out_scores[row] = scores[row][keep].tolist()
                out_ids[row] = ids_rows[row][keep].tolist()
        return out_scores, out_ids

    def _prep(self, depth: int, out_depth: Optional[int]):
        self.dense._materialize()
        plan = self.impact._search_plan(self.backend, depth)
        k_dense = min(depth, self.dense._n_valid)
        out_k = min(out_depth if out_depth is not None else depth,
                    plan["k"] + k_dense)
        return plan, out_k

    def _batch_chunks(self, plan, q_reps, q_idx, q_w, self_all):
        """Yield (chunk_i, chunk_w, dense_chunk, self_chunk, take) at the
        impact plan's chunk width; when a batch spans several chunks, the
        tail is zero-padded to that width (one shape per chunk)."""
        b = q_reps.shape[0]
        max_b = plan["max_b"]
        for start in range(0, b, max_b):
            end = min(start + max_b, b)
            chunk_i = q_idx[start:end]
            chunk_w = q_w[start:end]
            dense_chunk = np.ascontiguousarray(q_reps[start:end],
                                               dtype=np.float32)
            if end - start < max_b and b > max_b:
                pad = max_b - (end - start)
                chunk_i = np.concatenate(
                    [chunk_i, np.zeros((pad, chunk_i.shape[1]),
                                       chunk_i.dtype)])
                chunk_w = np.concatenate(
                    [chunk_w, np.zeros((pad, chunk_w.shape[1]),
                                       chunk_w.dtype)])
                dense_chunk = np.concatenate(
                    [dense_chunk,
                     np.zeros((pad, dense_chunk.shape[1]), np.float32)])
            self_chunk = np.full(chunk_i.shape[0], -1, np.int32)
            self_chunk[:end - start] = self_all[start:end]
            yield chunk_i, chunk_w, dense_chunk, self_chunk, end - start

    # ---- public API ----------------------------------------------------------
    def search_encoded_stream(self, batches, depth: int,
                              out_depth: Optional[int] = None,
                              lookahead: int = 3):
        """Pipelined fused search: one ``(scores, ids)`` pair per input
        batch ``(q_reps, q_idx, q_w[, qids])``, up to ``lookahead`` chunks
        in flight, so a chunk's copy to the host overlaps the next chunk's
        device work. A batch's qids turn on self-hit removal."""
        self._check_fresh()
        plan, out_k = self._prep(depth, out_depth)

        def submit():
            seq = 0
            for item in batches:
                q_reps, q_idx, q_w = item[:3]
                qids = item[3] if len(item) > 3 else None
                if q_idx.shape[0] != q_reps.shape[0]:
                    raise ValueError("dense/sparse query batch mismatch")
                self_all = self._self_indices(qids, q_reps.shape[0])
                chunks = list(self._batch_chunks(plan, q_reps, q_idx, q_w,
                                                 self_all))
                for ci, ch in enumerate(chunks):
                    yield ch + (ci == len(chunks) - 1, seq)
                    seq += 1

        out_s: List[List[float]] = []
        out_i: List[List[str]] = []
        expect_seq = 0

        def dispatch(item):
            chunk_i, chunk_w, dense_chunk, self_chunk, take, last, seq = item
            return (self._dispatch_fused(plan, chunk_i, chunk_w, dense_chunk,
                                         self_chunk, out_k), take, last, seq)

        def resolve(handle):
            nonlocal out_s, out_i, expect_seq
            packed, take, last, seq = handle
            # rows accumulate into their batch, so chunks must resolve in
            # the order they were submitted
            assert seq == expect_seq, (
                f"fused stream resolved chunk {seq} out of order "
                f"(expected {expect_seq})")
            expect_seq += 1
            s_c, i_c = self._resolve_fused(packed, take)
            out_s.extend(s_c)
            out_i.extend(i_c)
            if last:
                done_s, done_i = out_s, out_i
                out_s, out_i = [], []
                return done_s, done_i
            return None

        yield from pipeline_dispatch(submit(), dispatch, resolve, lookahead)

    def search_encoded(self, q_reps: np.ndarray, q_idx: np.ndarray,
                       q_w: np.ndarray, depth: int,
                       qids: Optional[Sequence[str]] = None,
                       out_depth: Optional[int] = None,
                       lookahead: int = 3
                       ) -> Tuple[List[List[float]], List[List[str]]]:
        """Fused hybrid top-``out_depth`` (default ``depth``) of one batch:
        (score rows, doc-id rows), fused-score-descending; each engine
        takes its top ``depth`` first. ``qids`` turn on ``remove_query``:
        the self doc is dropped after each run's min and max are taken."""
        for out in self.search_encoded_stream(
                [(q_reps, q_idx, q_w, qids)], depth, out_depth, lookahead):
            return out
        return [], []

    def eval_ranks(self, q_reps: np.ndarray, q_idx: np.ndarray,
                   q_w: np.ndarray, tgt: np.ndarray, depth: int,
                   qids: Optional[Sequence[str]] = None,
                   out_depth: Optional[int] = None,
                   lookahead: int = 3) -> np.ndarray:
        """Target ranks (``[B, 1+T]`` int32, see ``ops/eval_ranks.py``)
        from the fused top-k, without copying the run: the ranks of each
        chunk's fused result under rule ``'finite'`` (self-hit removal
        already happened inside the fusion). ``tgt`` holds dense-lookup
        positions (``eval.device_eval.dense_doc_pos``)."""
        from mllm_sparse_retrieval_tpu_torch.eval.device_eval import (
            _pad_rows, _ranks_pipeline)
        from mllm_sparse_retrieval_tpu_torch.ops.eval_ranks import (
            ranks_from_packed)

        self._check_fresh()
        plan, out_k = self._prep(depth, out_depth)
        self_all = self._self_indices(qids, q_reps.shape[0])

        def chunk_iter():
            pos = 0
            for ch in self._batch_chunks(plan, q_reps, q_idx, q_w, self_all):
                yield ch + (pos,)
                pos += ch[-1]

        def dispatch(item):
            chunk_i, chunk_w, dense_chunk, self_chunk, take, pos = item
            packed = self._dispatch_fused(plan, chunk_i, chunk_w,
                                          dense_chunk, self_chunk, out_k)
            bp = packed.shape[0]
            tgt_c = torch.from_numpy(
                _pad_rows(tgt[pos:pos + take], bp, -1)).to(self.device)
            no_self = torch.full((bp,), -1, dtype=torch.int32,
                                 device=self.device)
            return ranks_from_packed(packed, tgt_c, no_self,
                                     rule="finite"), take

        return _ranks_pipeline(chunk_iter(), dispatch, lookahead)

    def search_run(self, q_reps: np.ndarray, q_idx: np.ndarray,
                   q_w: np.ndarray, qids: Sequence[str], depth: int,
                   remove_query: bool = False,
                   out_depth: Optional[int] = None) -> Run:
        """Fused run (qid -> {doc_id: fused score}): the device route's
        counterpart of ``fuse([dense_run, sparse_run], ...)``, cut to the
        top ``out_depth`` fused docs of each query."""
        scores, ids = self.search_encoded(
            q_reps, q_idx, q_w, depth,
            qids=qids if remove_query else None, out_depth=out_depth)
        run: Dict[str, Dict[str, float]] = {}
        for qid, s_row, d_row in zip(qids, scores, ids):
            run[str(qid)] = dict(zip(d_row, s_row))
        return run

