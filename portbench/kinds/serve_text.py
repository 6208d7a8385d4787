"""Text-to-image retrieval as users query it: captions arriving on an open
loop at a fixed rate into ``RetrievalService.search_async(text=...)``.

Inputs, all from ``--seed``:

- the drawn tokenizer's lexicon and the model's weights (on the card);
- the corpus: ``docs`` images as documents of ``doc_terms`` distinct terms
  drawn without replacement with Zipf skew over the lexicon's word ids
  (the ids captions are made of, so queries hit postings), integer
  weights ``round(100 * log1p(x))`` of lognormal ``x``, and unit f32 dense
  rows of the decoder's width;
- the captions: the quantiles of a clipped lognormal length (every seed the
  same lengths, in its own order) of Zipf-drawn lexicon words;
- the arrivals: the quantiles of an exponential gap at ``rate_qps`` (a
  Poisson stream with every seed's gaps the same), in a seeded order.

Each query is timed from its due time to its result; the generator's lag
is logged. Stragglers are waited for up to ``straggler_timeout_s`` after
the window; one that fails or never comes counts as failed and as missing
every limit. The check then runs the plain reference over a seeded sample
of the window's queries (the longest caption always in it) and judges the
served lists: a query's regret is how far a served doc's reference score
lies below the reference's best at its rank, at its worst rank, and its
score gap how far a served score lies from that best. The compared numbers
are their means over the sample (``regret_mean``, ``score_gap_mean``):
one query's largest swings with the rounding of a near-empty sparse
vector (a term at weight 0 on one side and 1 on the other changes a whole
run), which bf16 against float32 does to a few queries in a thousand.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench import archs, core, flops, lexicon, peaks, runtime, stats
from portbench import trace as T
from portbench import weights as W
from portbench.reference import decoder as RD
from portbench.reference import retrieval as RR
from portbench.reference import strict_f32
from portbench.reference import text as RT
from portbench.reference.quant import Linear


@dataclass
class State:
    ctx: core.RunContext
    lex: List[str]
    tok: object
    arch: object
    params: dict
    corpus: RR.Corpus
    service: object = None
    encoder: object = None


def make_corpus(ctx, word_ids: torch.Tensor, dim: int) -> RR.Corpus:
    """The seeded corpus on the device (see the module docstring)."""
    c = ctx.mix["corpus"]
    n, k = c["docs"], c["doc_terms"]
    dev = ctx.device
    g = runtime.generator(ctx.seed, 3, dev)
    logp = -torch.log(torch.arange(1, word_ids.numel() + 1, device=dev,
                                   dtype=torch.float32))
    terms = torch.empty((n, k), dtype=torch.long, device=dev)
    for r0 in range(0, n, 2048):
        r1 = min(n, r0 + 2048)
        u = torch.rand((r1 - r0, word_ids.numel()), generator=g,
                       device=dev).clamp_(1e-12, 1 - 1e-7)
        keys = logp - torch.log(-torch.log(u))        # Gumbel top-k
        terms[r0:r1] = word_ids[keys.topk(k, dim=1).indices]
    x = torch.exp(torch.randn((n, k), generator=g, device=dev)
                  * c["weight_sigma"] + c["weight_mu"])
    w = torch.round(100.0 * torch.log1p(x)).clamp_(min=1.0)
    rows = torch.randn((n, dim), generator=g, device=dev)
    rows = rows / rows.norm(dim=1, keepdim=True)
    return RR.Corpus(terms, w, rows)


def setup(ctx: core.RunContext, with_service: bool = True) -> State:
    """Tokenizer, weights, corpus, the port's indexes, encoder and
    service."""
    mix = ctx.mix
    lex = lexicon.synthetic_lexicon(runtime.rng(ctx.seed, 1),
                                    mix["lexicon_words"])
    tok = lexicon.build_tokenizer(lex)
    arch = archs.port_arch(ctx.config, tok.special_ids)
    params = W.draw(arch, runtime.sub_seed(ctx.seed, 2), ctx.device)
    vocab = tok.get_vocab()
    word_ids = torch.tensor([vocab["▁" + w] for w in lex],
                            device=ctx.device)
    corpus = make_corpus(ctx, word_ids, arch.text.hidden_size)
    st = State(ctx, lex, tok, arch, params, corpus)
    if with_service:
        build_service(st)
    return st


def build_service(st: State) -> None:
    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)
    from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
        SelectedTerms)

    ctx, svc_cfg = st.ctx, st.ctx.mix["service"]
    n = st.corpus.doc_terms.shape[0]
    ids = [str(i) for i in range(n)]
    terms = st.corpus.doc_terms.cpu().numpy().astype(np.int32)
    wts = st.corpus.doc_weights.cpu().numpy().astype(np.int32)
    impact = ImpactIndex.from_selected_terms(
        ids, [SelectedTerms(t, w) for t, w in zip(terms, wts)],
        device=ctx.device)
    dense = DenseFlatIndex(st.arch.text.hidden_size, device=ctx.device)
    dense.add(st.corpus.rows.cpu().numpy(), ids)
    st.encoder = OnlineQueryEncoder(
        st.params, st.arch, st.tok, archs.template(ctx.config),
        SparseConfig(), max_text_len=svc_cfg["max_text_len"],
        device=ctx.device)
    st.service = RetrievalService(
        dense, impact_index=impact, query_encoder=st.encoder,
        alpha=svc_cfg["alpha"], depth_levels=tuple(svc_cfg["depth_levels"]),
        max_batch=svc_cfg["max_batch"], device_batch=svc_cfg["device_batch"],
        max_wait_ms=svc_cfg["max_wait_ms"])


def arrivals(n: int, rate: float, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """Due times (s from the window's start) of ``n`` queries: exponential
    gap quantiles at ``rate`` in a seeded order, scaled to end within the
    window."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    t = np.cumsum(rng.permutation(gaps))
    return t * min(1.0, seconds * (1 - 0.5 / max(n, 1)) / t[-1])


def traffic(st: State, purpose: int, seconds: float, rate: float):
    """(captions, due times) of an open-loop stream of ``seconds``."""
    ctx = st.ctx
    cw = ctx.mix["caption_words"]
    n = max(1, int(math.ceil(rate * seconds)))
    lens = lexicon.caption_lengths(n, cw["lo"], cw["hi"], cw["median"],
                                   cw["sigma"], runtime.rng(ctx.seed,
                                                            purpose))
    caps = lexicon.captions(runtime.rng(ctx.seed, purpose + 1), st.lex,
                            lens)
    due = arrivals(n, rate, seconds, runtime.rng(ctx.seed, purpose + 2))
    return caps, due


@dataclass
class Window:
    captions: List[str]
    due: np.ndarray             # absolute, perf_counter seconds
    done: np.ndarray            # absolute completion times (nan: none)
    kept: Dict[int, list]       # the answers of the queries to check
    t0: float
    t_end: float
    lag_s: np.ndarray
    batches: int
    items: int

    @property
    def latency_ms(self) -> np.ndarray:
        lat = (self.done - self.due) * 1e3
        return np.where(np.isfinite(lat), lat, np.inf)

    @property
    def failed(self) -> int:
        return int(np.sum(~np.isfinite(self.done)))


class _Answers:
    """Each answer's completion time, and the answers of the queries to
    check; nothing else of an answer is kept, so the window holds no more
    objects than a server would."""

    def __init__(self, n: int, keep):
        self.done = np.full(n, np.nan)
        self.keep = set(keep)
        self.kept: Dict[int, list] = {}
        self.left = n
        self.cond = threading.Condition()

    def callback(self, i: int):
        def done(fut):
            t = time.perf_counter()
            if fut.exception() is None:
                self.done[i] = t
                if i in self.keep:
                    self.kept[i] = fut.result()
            with self.cond:
                self.left -= 1
                if self.left == 0:
                    self.cond.notify_all()
        return done

    def wait(self, deadline: float) -> None:
        with self.cond:
            while self.left > 0:
                rest = deadline - time.perf_counter()
                if rest <= 0 or not self.cond.wait(rest):
                    break


def open_loop(svc, caps, due_rel, seconds, depth, timeout_s,
              keep=()) -> Window:
    """Send each caption at its due time, then wait for every answer up to
    ``timeout_s`` past the window's end. An answer that fails or does not
    come by then counts as failed; the answers of ``keep`` are kept."""
    n = len(caps)
    answers = _Answers(n, keep)
    lag = np.zeros(n)
    s0 = svc.stats()
    t0 = time.perf_counter() + 0.005
    due = t0 + np.asarray(due_rel)
    for i, cap in enumerate(caps):
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lag[i] = time.perf_counter() - due[i]
        svc.search_async(text=cap, depth=depth).add_done_callback(
            answers.callback(i))
    t_end = t0 + seconds
    answers.wait(t_end + timeout_s)
    done = answers.done.copy()
    s1 = svc.stats()
    return Window(list(caps), due, done, dict(answers.kept), t0, t_end, lag,
                  s1["batches"] - s0["batches"], s1["items"] - s0["items"])


def warm_up(st: State) -> None:
    """Every shape the window uses: full micro-batches, then a short open
    loop at the cell's rate."""
    ctx, mix = st.ctx, st.ctx.mix
    wu = mix["warmup"]
    b = mix["service"]["max_batch"]
    caps, _ = traffic(st, 20, wu["bursts"] * b / mix["rate_qps"],
                      mix["rate_qps"])
    for i in range(0, len(caps), b):
        for f in [st.service.search_async(text=c, depth=mix["depth"])
                  for c in caps[i:i + b]]:
            f.result(120)
    caps, due = traffic(st, 30, wu["open_loop_s"], mix["rate_qps"])
    open_loop(st.service, caps, due, wu["open_loop_s"], mix["depth"], 60)
    runtime.sync(ctx.device)


# ---- the check ---------------------------------------------------------------

def reference_lists(st: State, caps: List[str], lin: Linear):
    """The plain model's fused scores of each caption (doc index ->
    score), computed with ``lin``'s products."""
    ctx = st.ctx
    strict_f32()
    dims = RD.TextDims.from_config(ctx.config)
    vocab = RT.WordPieces(lexicon.vocabulary_words(st.lex),
                          lexicon.CHAT_SPECIALS)
    length = -(-ctx.mix["service"]["max_text_len"] // 16) * 16
    tpl = ctx.config["template"]
    out = []
    for i0 in range(0, len(caps), 32):
        chunk = caps[i0:i0 + 32]
        ids, mask = RT.right_pad(
            [vocab.encode(RT.text_prompt(tpl, c)) for c in chunk], length,
            vocab.pad_id)
        ids = torch.as_tensor(ids, device=ctx.device)
        mask = torch.as_tensor(mask, device=ctx.device)
        tp = st.params["text"]
        hidden = RD.decoder(tp, dims, tp["embed"][ids].float(), mask,
                            RD.text_positions(mask, dims), lin)
        sparse, dense = RD.reps(tp, dims, hidden, mask, lin)
        for j, cap in enumerate(chunk):
            terms = RR.query_terms(sparse[j], RT.candidate_ids(cap, vocab))
            out.append(RR.search(st.corpus, terms, dense[j],
                                 ctx.mix["depth"], ctx.mix["service"]["alpha"]))
    return out


def sample(ctx, caps: List[str]) -> List[int]:
    """A seeded sample of the window's queries, the longest caption in
    it (drawn before the window; one that fails is counted as failed)."""
    k = min(ctx.mix["check_sample"], len(caps))
    pick = set(runtime.rng(ctx.seed, 40).choice(len(caps), size=k,
                                                replace=False).tolist())
    pick.add(max(range(len(caps)), key=lambda i: len(caps[i])))
    return sorted(pick)


def judge(st: State, served: List[list], fused: List[dict]) -> dict:
    """The per-query regret and score gap over the checked queries: their
    means (the compared numbers) and their largest."""
    depth = st.ctx.mix["depth"]
    pairs = np.array([RR.judge(s, f, depth) for s, f in zip(served, fused)]
                     or [(0.0, 0.0)])
    return {"regret_mean": float(pairs[:, 0].mean()),
            "score_gap_mean": float(pairs[:, 1].mean()),
            "regret_max": float(pairs[:, 0].max()),
            "score_gap_max": float(pairs[:, 1].max())}


def as_served(fused: dict, depth: int) -> list:
    """A fused score dict as a served list (what the control serves)."""
    top = sorted(fused.items(), key=lambda kv: -kv[1])[:depth]
    return [(str(d), s) for d, s in top]


def checks(st: State, served: List[list], caps: List[str]
           ) -> List[core.Check]:
    ref = reference_lists(st, caps, Linear())
    numbers = judge(st, served, ref)
    return [core.Check(name, numbers[name], limit)
            for name, limit in st.ctx.limits.items()]


# ---- the traced slice --------------------------------------------------------

class _Recorder:
    """Wraps the encoder for the traced slice: each ``encode_texts`` call's
    texts and host seconds (it ends in the copy back)."""

    def __init__(self, enc):
        self._enc = enc
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def encode_texts(self, texts, pad_to=None):
        t0 = time.perf_counter()
        out = self._enc.encode_texts(texts, pad_to)
        self.calls.append((list(texts), t0, time.perf_counter()))
        return out


def encode_calls(st: State, rec: _Recorder) -> list:
    """Each recorded encoder call's queries, host seconds and model FLOPs
    (the real prompt tokens, cut to the encoder's length)."""
    vocab = RT.WordPieces(lexicon.vocabulary_words(st.lex),
                          lexicon.CHAT_SPECIALS)
    tpl = st.ctx.config["template"]
    length = -(-st.ctx.mix["service"]["max_text_len"] // 16) * 16
    calls = []
    for texts, t0, t1 in rec.calls:
        lens = [min(length, len(vocab.encode(RT.text_prompt(tpl, c))))
                for c in texts]
        calls.append({"queries": len(texts), "seconds": t1 - t0,
                      "flops": flops.decoder_forward(st.ctx.config, lens)})
    return calls


def traced_slice(st: State) -> dict:
    """An open loop of ``trace_seconds`` at the cell's rate under the
    profiler, after the window: what the device-side readers read."""
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP

    ctx, mix = st.ctx, st.ctx.mix
    caps, due = traffic(st, 50, mix["trace_seconds"], mix["rate_qps"])
    launches = []
    taat = SP.impact_scores_taat

    def recorded(matrix, idx, w):
        launches.append((matrix.shape[1], matrix.element_size(), idx, w))
        return taat(matrix, idx, w)

    SP.impact_scores_taat = recorded
    K.reset_launch_count()
    try:
        win, tr = T.profiled(
            lambda: open_loop(st.service, caps, due, mix["trace_seconds"],
                              mix["depth"], 60),
            lambda: runtime.sync(ctx.device))
    finally:
        SP.impact_scores_taat = taat
    bounds = []
    for n_cols, elem, idx, w in launches:
        live = (idx > 0) & (w != 0)
        bounds.append(peaks.taat_bound(
            int(torch.unique(idx[live]).numel()), int(live.sum()),
            idx.shape[0], idx.shape[1], n_cols, elem))
    taat_n = tr.kernel_s("taat")[1]
    notes = []
    if taat_n != K.launch_count():
        notes.append(f"trace: {taat_n} TAAT kernels in the profile, "
                     f"{K.launch_count()} launches counted")
    return {"trace": tr, "slice_queries": win.items,
            "taat_bounds_s": bounds, "slice_failed": win.failed,
            "notes": notes}


# ---- the run -----------------------------------------------------------------

def run(ctx: core.RunContext) -> core.Outcome:
    st = setup(ctx)
    warm_up(st)
    caps, due = traffic(st, 10, ctx.seconds, ctx.mix["rate_qps"])
    rec = _Recorder(st.encoder) if ctx.trace else None
    if rec is not None:
        st.service.query_encoder = rec
    runtime.reset_peak(ctx.device)
    t_first = time.perf_counter()
    setup_s = t_first - ctx.t_start
    pick = sample(ctx, caps)
    win = open_loop(st.service, caps, due, ctx.seconds, ctx.mix["depth"],
                    ctx.mix["straggler_timeout_s"], keep=pick)
    layer = None
    if ctx.trace:
        st.service.query_encoder = st.encoder
        layer = traced_slice(st)
        layer["encode_calls"] = encode_calls(st, rec)
    peak = runtime.peak_bytes(ctx.device)
    lat = win.latency_ms
    answered = int(np.sum(np.isfinite(win.done) & (win.done <= win.t_end)))
    e2e = {"query_p95_ms": stats.percentile(lat.tolist(), 95),
           "queries_per_s": answered / ctx.seconds,
           "setup_s": setup_s}
    notes = [f"window: {len(caps)} queries offered at "
             f"{ctx.mix['rate_qps']} /s, {answered} answered in the window,"
             f" {win.failed} failed, {win.batches} micro-batches "
             f"({win.items / max(win.batches, 1):.2f} a batch); generator "
             f"lag p50 {np.median(win.lag_s) * 1e3:.3f} ms, max "
             f"{win.lag_s.max() * 1e3:.3f} ms; p50 "
             f"{stats.percentile(lat.tolist(), 50):.3f} ms"]
    st.service.close()
    st.service = st.encoder = None
    runtime.release(ctx.device)
    pick = [i for i in pick if i in win.kept]
    t_ref = time.perf_counter()
    chk = checks(st, [win.kept[i] for i in pick],
                 [win.captions[i] for i in pick])
    notes.append(f"reference over {len(pick)} queries in "
                 f"{time.perf_counter() - t_ref:.2f} s")
    out = core.Outcome(attempted=len(caps), failed=win.failed, e2e=e2e,
                       checks=chk, memory_peak_bytes=peak, notes=notes)
    if layer is not None:
        tr = layer["trace"]
        out.busy_s = tr.busy_s()
        out.window_s = tr.window_s
        out.breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        layer.update({"serve_batches": win.batches, "serve_items": win.items,
                      "latency_ms": lat.tolist(),
                      "peak_flops": peaks.BF16_OPS_PER_S})
        out.layer = layer
        out.notes += layer["notes"]
    return out


def control(ctx: core.RunContext) -> dict:
    """The control's numbers: the reference in float8 (``Linear(fp8=
    True)``) put in the program's place, over the queries a run of this
    seed samples, judged against the float32 reference."""
    st = setup(ctx, with_service=False)
    caps, _ = traffic(st, 10, ctx.seconds, ctx.mix["rate_qps"])
    caps = [caps[i] for i in sample(ctx, caps)]
    ref = reference_lists(st, caps, Linear())
    ctrl = reference_lists(st, caps, Linear(fp8=True))
    depth = ctx.mix["depth"]
    return judge(st, [as_served(f, depth) for f in ctrl], ref)


def sweep(ctx: core.RunContext, rates) -> list:
    """One window of ``ctx.seconds`` at each offered rate on one warm
    service: what sets a cell's fixed rate. A rate is sustained where the
    answered rate keeps up with the offered one and the latency of the
    window's last third stays near its first third's."""
    st = setup(ctx)
    warm_up(st)
    rows = []
    for k, rate in enumerate(rates):
        caps, due = traffic(st, 100 + 10 * k, ctx.seconds, rate)
        win = open_loop(st.service, caps, due, ctx.seconds,
                        ctx.mix["depth"], ctx.mix["straggler_timeout_s"])
        lat = win.latency_ms
        third = max(1, len(lat) // 3)
        answered = int(np.sum(np.isfinite(win.done)
                              & (win.done <= win.t_end)))
        rows.append({
            "rate": rate, "offered": len(caps), "answered": answered,
            "queries_per_s": answered / ctx.seconds,
            "p50_ms": stats.percentile(lat.tolist(), 50),
            "p95_ms": stats.percentile(lat.tolist(), 95),
            "first_third_p50_ms": stats.percentile(lat[:third].tolist(), 50),
            "last_third_p50_ms": stats.percentile(lat[-third:].tolist(), 50),
            "batch_mean": win.items / max(win.batches, 1),
            "lag_max_ms": float(win.lag_s.max() * 1e3)})
    st.service.close()
    return rows
