"""PyTorch port: runs, fusion, TREC IO, recall and ranking metrics
(``search/{runs,fusion}.py``, ``eval/{recall,metrics}.py``) against the JAX
package's on seeded runs, and ``search/engine.run_search`` end to end
against the JAX ``run_search`` on one corpus CSV (written here), one tiny
model (weights carried across) and indexes built from each package's own
artifacts.

Tolerances:

- runs, fusion, TREC files, recall and metric values on the same input
  runs: exact (the same float operations in the same order);
- ``run_search``: sparse runs (integer scores) equal as ``(doc, score)``
  sets, dense scores within ``1e-5``, in both cases up to docs tied at the
  depth cut (tie order is not part of the contract: ``torch.topk`` and
  ``lax.top_k`` order equal scores differently). Fused min-max scores move
  by at most ``4e-5 * alpha / (max - min)`` of the query's dense run
  (each of a score, the min and the max moves by at most ``1e-5``); RRF
  scores are exact away from ties. Recall and the metrics are computed on
  each package's own run, so they are compared exactly where no target
  sits in a tie at a cutoff: ``_no_target_tied_at_a_cut`` checks that this
  holds for the seeds and cutoffs used here before the values are
  compared.
"""

import csv

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SearchConfig as JSearchConfig
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.karpathy import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu.eval import metrics as jmetrics
from mllm_sparse_retrieval_tpu.eval import recall as jrecall
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.search import engine as jengine
from mllm_sparse_retrieval_tpu.search import fusion as jfusion
from mllm_sparse_retrieval_tpu.search import runs as jruns
from mllm_sparse_retrieval_tpu.sparse import (
    canonical_id_map as j_canonical_id_map)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SearchConfig, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.eval import metrics, recall
from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex, ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.search import engine, fusion, runs
from mllm_sparse_retrieval_tpu_torch.sparse import (
    SelectedTerms, canonical_id_map)

KS = (1, 3, 5, 10, 100)
DEPTH = 100

# ---- seeded runs ------------------------------------------------------------


def _rows(seed, n_q=25, n_docs=40, depth=12, int_ids=False, ties=True):
    """(qids, score rows, id rows): descending rows with integer-valued
    ties when ``ties``, one duplicate qid, one empty row, a self hit."""
    rng = np.random.default_rng(seed)
    qids = [f"q{i}" for i in range(n_q)]
    qids[7] = "q3"                                  # duplicate qid
    scores, ids = [], []
    for i in range(n_q):
        k = 0 if i == 11 else int(rng.integers(1, depth + 1))
        s = rng.integers(1, 30, size=k).astype(float) if ties else \
            rng.standard_normal(k)
        s = sorted(s.tolist(), reverse=True)
        d = rng.choice(n_docs, size=k, replace=False).tolist()
        d = [int(x) if int_ids else f"d{x}" for x in d]
        if k > 2:
            d[1] = int(qids[i][1:]) if int_ids else qids[i]   # self hit
        scores.append(s)
        ids.append(d)
    return qids, scores, ids


def _target(qid):
    n = int(qid[1:])
    return [f"d{n % 40}", f"d{(3 * n) % 40}"] if n % 2 else f"d{n % 40}"


@pytest.mark.parametrize("remove_query", [False, True])
@pytest.mark.parametrize("scores_sorted", [False, True])
@pytest.mark.parametrize("int_ids", [False, True])
def test_make_run_and_array_run_match_jax(remove_query, scores_sorted,
                                          int_ids):
    qids, scores, ids = _rows(1, int_ids=int_ids)
    got = runs.make_run(qids, scores, ids, remove_query, scores_sorted)
    want = jruns.make_run(qids, scores, ids, remove_query, scores_sorted)
    assert got == want
    assert [list(e["docs"].items()) for e in got.values()] == \
        [list(e["docs"].items()) for e in want.values()]
    arr = runs.ArrayRun(qids, scores, ids, remove_query, scores_sorted)
    jarr = jruns.ArrayRun(qids, scores, ids, remove_query, scores_sorted)
    assert list(arr) == list(jarr) and len(arr) == len(jarr)
    assert list(arr.iter_ranked()) == list(jarr.iter_ranked())
    assert ("q3" in arr) and bool(arr)
    assert arr == got and arr.materialize() == want
    # numpy rows (raw batch_search output) take the same path
    np_run = runs.make_run(qids[:5], [np.asarray(s, np.float32)
                                      for s in scores[:5]],
                           [np.asarray(i) for i in ids[:5]], remove_query)
    assert np_run == jruns.make_run(
        qids[:5], [np.asarray(s, np.float32) for s in scores[:5]],
        [np.asarray(i) for i in ids[:5]], remove_query)
    assert runs.merge_runs([got, {"z": {"docs": {}}}]) == \
        jruns.merge_runs([want, {"z": {"docs": {}}}])


def _seeded_runs():
    q1, s1, i1 = _rows(2, ties=False)
    q2, s2, i2 = _rows(3)
    q2 = q2[:-3] + ["x1", "x2", "x3"]                # asymmetric qids
    return (runs.ArrayRun(q1, s1, i1, scores_sorted=True),
            runs.make_run(q2, s2, i2),
            jruns.ArrayRun(q1, s1, i1, scores_sorted=True),
            jruns.make_run(q2, s2, i2))


def _same_fused(got, want):
    assert set(got) == set(want)
    for q in got:
        assert list(got[q].items()) == list(want[q].items())


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_fusion_matches_jax(alpha):
    d, s, jd, js = _seeded_runs()
    w = [alpha, 1.0 - alpha]
    _same_fused(fusion.fuse([d, s], w), jfusion.fuse([jd, js], w))
    _same_fused(fusion.fuse_rrf([d, s], w), jfusion.fuse_rrf([jd, js], w))
    _same_fused(fusion.fuse_rrf([d, s], k=10),
                jfusion.fuse_rrf([jd, js], k=10))
    got = fusion.fuse_statistic([d, s], w)
    want = jfusion.fuse_statistic([jd, js], w)
    assert {q: {k: (r.score, r.type) for k, r in v.items()}
            for q, v in got.items()} == \
        {q: {k: (r.score, r.type) for k, r in v.items()}
         for q, v in want.items()}
    fused = fusion.fuse([d, s], w)
    for q in ("q4", "x2"):
        for doc in list(fused.get(q, {}))[:3]:
            e = fusion.explain_fusion([d.materialize(), s], w, q, doc)
            assert e == jfusion.explain_fusion([jd.materialize(), js], w,
                                               q, doc)
            assert e["score"] == pytest.approx(fused[q][doc], abs=1e-12)


def test_trec_round_trip_across_packages(tmp_path):
    d, s, jd, js = _seeded_runs()
    fused = fusion.fuse([d, s], [0.5, 0.5])
    jfused = jfusion.fuse([jd, js], [0.5, 0.5])
    for name, mine, theirs in (("dense", d, jd), ("sparse", s, js),
                               ("fusion", fused, jfused)):
        p, j = tmp_path / f"p_{name}.trec", tmp_path / f"j_{name}.trec"
        fusion.write_trec_run(mine, str(p), name)
        jfusion.write_trec_run(theirs, str(j), name)
        if name == "fusion":
            # fused qids come from a set: compare the per-query blocks
            def blocks(path):
                out = {}
                for line in path.read_text().splitlines():
                    out.setdefault(line.split()[0], []).append(line)
                return out
            assert blocks(p) == blocks(j)
        else:
            assert p.read_text() == j.read_text()
        back, jback = fusion.read_trec_run(str(j)), jfusion.read_trec_run(
            str(p))
        assert back == jback == jfusion.read_trec_run(str(j))


@pytest.mark.parametrize("which", ["dense", "sparse", "fusion"])
def test_recall_and_metrics_match_jax(which):
    d, s, jd, js = _seeded_runs()
    # a fused run's qid order comes from a set, and a mean over queries
    # depends on the order of its sum: both packages read one fused run
    fused = fusion.fuse([d, s], [0.4, 0.6])
    run, jrun = {"dense": (d, jd), "sparse": (s, js),
                 "fusion": (fused, fused)}[which]
    for denom in (None, 40):
        got = recall.recall_at_k(run, _target, KS, denominator=denom)
        want = jrecall.recall_at_k(jrun, _target, KS, denominator=denom)
        assert (got.recalls, got.hits, got.num_queries) == \
            (want.recalls, want.hits, want.num_queries)
        assert got.format(which) == want.format(which)
        assert got[5] == want[5]
        m = metrics.ranking_metrics(run, _target, KS, denom)
        jm = jmetrics.ranking_metrics(jrun, _target, KS, denom)
        assert {k: (v.values, v.num_queries) for k, v in m.items()} == \
            {k: (v.values, v.num_queries) for k, v in jm.items()}
        for fn, jfn in ((metrics.mrr_at_k, jmetrics.mrr_at_k),
                        (metrics.ndcg_at_k, jmetrics.ndcg_at_k),
                        (metrics.map_at_k, jmetrics.map_at_k)):
            a, b = fn(run, _target, KS, denom), jfn(jrun, _target, KS, denom)
            assert a.values == b.values and a.format("x") == b.format("x")
    assert recall.DEFAULT_KS == jrecall.DEFAULT_KS
    with pytest.raises(ValueError, match="unknown metrics"):
        metrics.ranking_metrics(run, _target, KS, which=("mrr", "p"))


# ---- run_search end to end --------------------------------------------------

WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball", "people",
         "ride", "bikes", "play", "holds", "near", "blue", "small"]
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
N_IMAGES, CAPS = 12, 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Corpus, tiny model in both packages, and each package's indexes
    built from its own artifacts: dense pickles, jsonl impact indexes, and
    int-keyed indexes from the selected terms with the canonical map."""
    root = tmp_path_factory.mktemp("search")
    rng = np.random.default_rng(21)
    (root / "flickr").mkdir()
    with open(root / "flickr" / "flickr_test.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["imgid", "filename", "caption", "sentid"])
        for i in range(N_IMAGES):
            for c in range(CAPS):
                w.writerow([f"{500 + i}", f"{500 + i}.jpg", " ".join(
                    rng.choice(WORDS, size=int(rng.integers(3, 8)))),
                    f"{9000 + CAPS * i + c}"])
    corpus = CrossModalCorpus("flickr", "test", str(root))
    jcorpus = JCorpus("flickr", "test", str(root))
    caps = list(corpus.text_dict.values())
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
        captions=caps, seed=0)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        caps, vocab_size=TINY["tiny_vocab_size"])
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **TINY))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    model = dict(p=(params, spec.arch, tok, spec.template),
                 j=(jparams, jarch, jtok, jtmpl))
    idx = {}
    for kind, mode in (("text", "full"), ("image", "single")):
        enc = pencode.encode_examples(
            corpus.examples(mode), *model["p"], encode_type=kind,
            sparse_cfg=SparseConfig(), batch_size=8, device="cpu")
        jenc = jencode.encode_examples(
            jcorpus.examples(mode), *model["j"], encode_type=kind,
            sparse_cfg=JSparseConfig(), batch_size=8)
        for pkg, res, write in (("p", enc, pencode.write_artifacts),
                                ("j", jenc, jencode.write_artifacts)):
            write(res, str(root / pkg / kind / "dense"),
                  str(root / pkg / kind / "sparse"))
        sp = [str(root / "p" / kind / "sparse" / "corpus_0.jsonl")]
        sj = [str(root / "j" / kind / "sparse" / "corpus_0.jsonl")]
        idx[kind] = dict(
            dense=(DenseFlatIndex.load(str(root / "p" / kind / "dense"),
                                       device="cpu"),
                   JDenseFlatIndex.load(str(root / "j" / kind / "dense"))),
            jsonl=(ImpactIndex.from_jsonl(sp, device="cpu"),
                   JImpactIndex.from_jsonl(sj, use_native=False)),
            terms=(ImpactIndex.from_selected_terms(
                enc.ids, [SelectedTerms(t.token_ids, t.weights)
                          for t in enc.selected_terms],
                canonical_id_map(tok.get_vocab(), True), device="cpu"),
                JImpactIndex.from_selected_terms(
                    jenc.ids, jenc.selected_terms,
                    j_canonical_id_map(jtok.get_vocab(), True))))
    return dict(corpus=corpus, jcorpus=jcorpus, model=model, idx=idx)


def _targets(world, qtype, corpus_kind):
    c = world["corpus"]
    if qtype == corpus_kind:          # text -> text: the sibling captions
        return lambda q: c.img2text[c.text2img[q]]
    return lambda q: c.get_target(q, qtype)


def _run(world, qtype, corpus_kind, sparse_kind="jsonl", dense=True,
         sparse=True, **kw):
    mode = "full" if qtype == "text" else "single"
    scfg = kw.pop("search_cfg", dict(depth=DEPTH))
    ix = world["idx"][corpus_kind]
    dp, dj = ix["dense"] if dense else (None, None)
    ip, ij = ix[sparse_kind] if sparse else (None, None)
    tgt = _targets(world, qtype, corpus_kind)
    got = engine.run_search(
        world["corpus"].examples(mode), *world["model"]["p"],
        query_type=qtype, sparse_cfg=SparseConfig(),
        search_cfg=SearchConfig(**scfg), dense_index=dp, impact_index=ip,
        batch_size=8, get_target=tgt, ks=KS, device="cpu", **kw)
    want = jengine.run_search(
        world["jcorpus"].examples(mode), *world["model"]["j"],
        query_type=qtype, sparse_cfg=JSparseConfig(),
        search_cfg=JSearchConfig(**scfg), dense_index=dj, impact_index=ij,
        batch_size=8, get_target=tgt, ks=KS, **kw)
    return got, want, tgt


def _rows_of(run):
    """qid -> [(doc, score)] in the run's rank order."""
    out = {}
    for q in run:
        e = run[q]
        docs = e["docs"] if "docs" in e else e
        out[q] = sorted(docs.items(), key=lambda kv: kv[1], reverse=True)
    return out


def _same_run(got, want, tol, depth=DEPTH):
    """Same queries; each query's scores within ``tol`` rank by rank; every
    doc above the cut (``tol`` of tie room) in both runs, its two scores
    within ``tol``. Returns the largest score difference of a doc found in
    both runs."""
    g, w = _rows_of(got), _rows_of(want)
    assert set(g) == set(w)
    worst = 0.0
    for q in g:
        a, b, t = g[q], w[q], tol[q] if isinstance(tol, dict) else tol
        assert len(a) == len(b)
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                   rtol=0, atol=t)
        bs = dict(b)
        cut = a[-1][1] + 2 * t if len(a) >= depth else -np.inf
        for doc, s in a:
            if doc in bs:
                worst = max(worst, abs(bs[doc] - s))
            if s > cut:
                assert doc in bs and abs(bs[doc] - s) <= t + 1e-12
    return worst


def _no_target_tied_at_a_cut(run, tgt, ks, tie):
    """True when no query has a target among the docs within ``tie`` of
    the last doc kept at any cutoff, with another doc on the other side of
    the cut (so recall there does not depend on the order of scores that
    the two packages may round differently)."""
    for q, rows in _rows_of(run).items():
        t = tgt(q)
        targets = {str(x) for x in t} if isinstance(t, list) else {str(t)}
        for k in ks:
            if len(rows) <= k:
                continue
            edge = rows[k - 1][1]
            if abs(rows[k][1] - edge) <= tie and any(
                    d in targets and abs(s - edge) <= tie for d, s in rows):
                return False
    return True


def _same_eval(got, want, tgt, ties):
    """Recall and metrics equal, after checking that no target sits in a
    tie at a cutoff. ``ties[name]`` is twice the largest difference between
    the packages' scores of one doc in that run (0 for the integer sparse
    scores): two docs can change order between the packages only when
    their gap is below it."""
    for name in ("dense", "sparse", "fusion"):
        g, w = getattr(got, f"{name}_recall"), getattr(want, f"{name}_recall")
        assert (g is None) == (w is None)
        if g is None:
            continue
        for out in (got, want):
            assert _no_target_tied_at_a_cut(getattr(out, f"{name}_run"),
                                            tgt, KS, ties[name]), name
        assert (g.recalls, g.hits, g.num_queries) == \
            (w.recalls, w.hits, w.num_queries), name
        ge, we = got.extra_metrics.get(name, {}), want.extra_metrics.get(
            name, {})
        assert set(ge) == set(we)
        for m in ge:
            assert ge[m].values == pytest.approx(we[m].values, abs=1e-12)


def _compare_hybrid(got, want, tgt, alpha=0.5):
    ties = dict(dense=2 * _same_run(got.dense_run, want.dense_run, 1e-5),
                sparse=2 * _same_run(got.sparse_run, want.sparse_run, 0.0))
    ties["fusion"] = 2 * _same_run(got.fusion_run, want.fusion_run,
                                   _fusion_tol(got, alpha))
    _same_eval(got, want, tgt, ties)


def _fusion_tol(got, alpha):
    dense = got.dense_run
    return {q: 4e-5 * alpha / max(dense[q]["max_score"] -
                                  dense[q]["min_score"], 1e-9) + 1e-9
            for q in dense}


@pytest.mark.parametrize("qtype,corpus_kind,sparse_kind", [
    ("text", "image", "jsonl"),
    ("image", "text", "jsonl"),
    ("text", "image", "terms"),
    ("image", "text", "terms"),
])
def test_run_search_hybrid_matches_jax(world, qtype, corpus_kind,
                                       sparse_kind):
    got, want, tgt = _run(world, qtype, corpus_kind, sparse_kind,
                          metrics=("mrr", "ndcg", "map"))
    _compare_hybrid(got, want, tgt)
    assert got.summary().splitlines()[0].startswith("dense recall: r@1 ")
    assert len(got.summary().splitlines()) == 12


def test_run_search_rrf_and_single_index_match_jax(world):
    got, want, tgt = _run(world, "text", "image", fusion_rule="rrf",
                          search_cfg=dict(depth=DEPTH, alpha=0.3))
    ties = dict(dense=2 * _same_run(got.dense_run, want.dense_run, 1e-5),
                sparse=2 * _same_run(got.sparse_run, want.sparse_run, 0.0))
    # an RRF score depends on the rank a tie block gives each of its docs,
    # so the engine's fused run is held to each package's fuse_rrf of the
    # port's own dense and sparse runs
    w = [0.3, 0.7]
    runs_in = [got.dense_run.materialize(), got.sparse_run.materialize()]
    _same_fused(got.fusion_run, fusion.fuse_rrf(runs_in, w))
    _same_fused(got.fusion_run, jfusion.fuse_rrf(runs_in, w))
    assert recall.recall_at_k(got.fusion_run, tgt, KS).recalls == \
        jrecall.recall_at_k(got.fusion_run, tgt, KS).recalls
    got.fusion_recall = want.fusion_recall = None
    _same_eval(got, want, tgt, ties)
    got, want, tgt = _run(world, "image", "text", sparse=False)
    assert got.sparse_run == {} and got.fusion_run == {}
    _same_eval(got, want, tgt, dict(
        dense=2 * _same_run(got.dense_run, want.dense_run, 1e-5)))
    got, want, tgt = _run(world, "text", "image", dense=False,
                          search_cfg=dict(depth=5))
    assert got.dense_recall is None and got.fusion_recall is None
    _same_run(got.sparse_run, want.sparse_run, 0.0, depth=5)


def test_run_search_remove_query_matches_jax(world):
    got, want, tgt = _run(world, "text", "text",
                          search_cfg=dict(depth=DEPTH, remove_query=True))
    for run in (got.dense_run, got.sparse_run):
        for q, rows in _rows_of(run).items():
            assert q not in dict(rows)
    _compare_hybrid(got, want, tgt)


def test_run_search_runs_only_without_targets(world):
    out = engine.run_search(
        world["corpus"].examples("full")[:5], *world["model"]["p"],
        query_type="text", sparse_cfg=SparseConfig(),
        search_cfg=SearchConfig(depth=3),
        dense_index=world["idx"]["image"]["dense"][0], device="cpu")
    assert len(out.dense_run) == 5 and out.dense_recall is None
    assert out.summary() == ""


@pytest.mark.parametrize("kw,err,match", [
    (dict(fusion_mode="gpu"), ValueError, "fusion_mode"),
    (dict(eval_mode="gpu"), ValueError, "eval_mode"),
    (dict(fusion_rule="max"), ValueError, "fusion_rule"),
    (dict(eval_mode="device", get_target=None), ValueError, "get_target"),
    (dict(eval_mode="device"), ValueError, "BOTH indexes"),
    (dict(fusion_mode="device", fusion_rule="rrf"), ValueError,
     "host-path only"),
    (dict(fusion_mode="device", impact_index=None), ValueError, "BOTH a"),
    (dict(impact_wire="zstd"), ValueError, "wire"),
])
def test_run_search_argument_checks(world, kw, err, match):
    args = dict(query_type="text", sparse_cfg=SparseConfig(),
                search_cfg=SearchConfig(depth=3),
                dense_index=world["idx"]["image"]["dense"][0],
                impact_index=world["idx"]["image"]["jsonl"][0],
                get_target=lambda q: q, device="cpu")
    args.update(kw)
    with pytest.raises(err, match=match):
        engine.run_search(world["corpus"].examples("full")[:2],
                          *world["model"]["p"], **args)
    if err is ValueError:     # the JAX package refuses the same arguments
        jargs = dict(args, sparse_cfg=JSparseConfig(),
                     search_cfg=JSearchConfig(depth=3),
                     dense_index=world["idx"]["image"]["dense"][1],
                     impact_index=(None if args["impact_index"] is None
                                   else world["idx"]["image"]["jsonl"][1]))
        jargs.pop("device")
        with pytest.raises(ValueError, match=match):
            jengine.run_search(world["jcorpus"].examples("full")[:2],
                               *world["model"]["j"], **jargs)


def _device_run(world, qtype, corpus_kind, sparse_kind, **kw):
    got, want, tgt = _run(world, qtype, corpus_kind, sparse_kind,
                          metrics=("mrr", "ndcg", "map"), **kw)
    for out in (got, want):
        assert out.dense_run == out.sparse_run == {}
    return got, want, tgt


@pytest.mark.parametrize("qtype,corpus_kind,sparse_kind,remove_query", [
    ("text", "image", "jsonl", False),
    ("image", "text", "terms", False),
    ("text", "text", "jsonl", True),
])
def test_run_search_device_fusion_matches_jax(world, qtype, corpus_kind,
                                              sparse_kind, remove_query):
    """``fusion_mode="device"``: the fused run and its recall and metrics
    against the JAX package's device route, and the run against the host
    route's fused run of the port cut to ``depth``."""
    scfg = dict(depth=DEPTH, remove_query=remove_query)
    got, want, tgt = _device_run(world, qtype, corpus_kind, sparse_kind,
                                 fusion_mode="device", search_cfg=scfg)
    assert got.dense_recall is got.sparse_recall is None
    host, _, _ = _run(world, qtype, corpus_kind, sparse_kind,
                      search_cfg=dict(scfg))
    tol = _fusion_tol(host, 0.5)
    # the device route keeps the top depth of the fused union: the host
    # route's fused run cut there
    cut = {q: dict(sorted(d.items(), key=lambda kv: -kv[1])[:DEPTH])
           for q, d in host.fusion_run.items()}
    _same_run(got.fusion_run, cut, tol)
    worst = _same_run(got.fusion_run, want.fusion_run, tol)
    _same_eval(got, want, tgt, dict(fusion=2 * worst + 1e-6))
    if remove_query:
        for q, rows in _rows_of(got.fusion_run).items():
            assert q not in dict(rows)


@pytest.mark.parametrize("sparse_kind,fusion_mode", [
    ("jsonl", "host"), ("terms", "host"), ("jsonl", "device")])
def test_run_search_compact48_matches_jax(world, sparse_kind, fusion_mode):
    """``impact_wire="compact48"``: the sparse run equals the i32 wire's
    exactly and the JAX package's compact48 run; the device-fused route
    keeps the i32 wire inside the device, as the JAX searcher does."""
    kw = dict(impact_wire="compact48", search_cfg=dict(depth=DEPTH))
    if fusion_mode == "device":
        got, want, tgt = _device_run(world, "text", "image", sparse_kind,
                                     fusion_mode="device", **kw)
        i32, _, _ = _device_run(world, "text", "image", sparse_kind,
                                fusion_mode="device")
        assert got.fusion_run == i32.fusion_run
        host, _, _ = _run(world, "text", "image", sparse_kind)
        _same_eval(got, want, tgt, dict(fusion=2 * _same_run(
            got.fusion_run, want.fusion_run, _fusion_tol(host, 0.5)) + 1e-6))
        return
    got, want, tgt = _run(world, "text", "image", sparse_kind, **kw)
    i32, _, _ = _run(world, "text", "image", sparse_kind,
                     search_cfg=dict(depth=DEPTH))
    assert _rows_of(got.sparse_run) == _rows_of(i32.sparse_run)
    assert got.sparse_run.materialize() == i32.sparse_run.materialize()
    _compare_hybrid(got, want, tgt)


def test_run_search_device_fusion_takes_two_device_spellings(world,
                                                             tmp_path):
    """A dense index on ``cpu`` beside an impact index on ``cpu:0`` is one
    device: the device-fused route builds and gives the same run."""
    impact = world["idx"]["image"]["jsonl"][0]
    impact.save(str(tmp_path / "idx"))
    spelled = ImpactIndex.load(str(tmp_path / "idx"), device="cpu:0")
    args = dict(query_type="text", sparse_cfg=SparseConfig(),
                search_cfg=SearchConfig(depth=10),
                dense_index=world["idx"]["image"]["dense"][0],
                fusion_mode="device", device="cpu")
    queries = world["corpus"].examples("full")[:6]
    got = engine.run_search(queries, *world["model"]["p"],
                            impact_index=spelled, **args)
    want = engine.run_search(queries, *world["model"]["p"],
                             impact_index=impact, **args)
    assert got.fusion_run == want.fusion_run and len(got.fusion_run) == 6


@pytest.mark.parametrize("fusion_mode,dense,sparse", [
    ("device", True, True),
    ("host", True, False),
    ("host", False, True),
])
def test_run_search_device_eval_matches_jax(world, fusion_mode, dense,
                                            sparse):
    """``eval_mode="device"``: no run leaves the device; recall and the
    metrics equal the JAX package's device evaluation and the port's host
    evaluation of the same search."""
    kw = dict(fusion_mode=fusion_mode, dense=dense, sparse=sparse)
    got, want, tgt = _device_run(world, "text", "image", "jsonl",
                                 eval_mode="device", **kw)
    assert got.fusion_run == {}
    host, _, _ = _run(world, "text", "image", "jsonl",
                      metrics=("mrr", "ndcg", "map"), **kw)
    for name in ("dense", "sparse", "fusion"):
        g, w, h = (getattr(o, f"{name}_recall") for o in (got, want, host))
        assert (g is None) == (w is None) == (h is None)
        if g is None:
            continue
        run = getattr(host, f"{name}_run")
        assert _no_target_tied_at_a_cut(run, tgt, KS, 2e-5)
        for other in (w, h):
            assert (g.recalls, g.hits, g.num_queries) == \
                (other.recalls, other.hits, other.num_queries), name
        for extras in (want.extra_metrics[name], host.extra_metrics[name]):
            assert set(extras) == set(got.extra_metrics[name])
            for m, r in extras.items():
                assert got.extra_metrics[name][m].values == pytest.approx(
                    r.values, abs=1e-12)


def test_canonical_map_is_cached_per_tokenizer(world):
    tok = world["model"]["p"][2]
    a = engine._canonical_map_for(tok, True)
    assert engine._canonical_map_for(tok, True) is a
    np.testing.assert_array_equal(a, canonical_id_map(tok.get_vocab(), True))
    terms_index = world["idx"]["image"]["terms"][0]
    assert engine._query_cmap(terms_index, tok, SparseConfig()) is a
    assert engine._query_cmap(world["idx"]["image"]["jsonl"][0], tok,
                              SparseConfig()) is None
