"""The traffic generators: the same seed gives the same inputs, and the
draws have the shapes the mixes state."""

import numpy as np
import pytest

from portbench import lexicon, runtime
from portbench.kinds import serve_text


def test_lexicon_and_captions_are_seeded():
    a = lexicon.synthetic_lexicon(runtime.rng(2 ** 31 + 7, 1), 500)
    b = lexicon.synthetic_lexicon(runtime.rng(2 ** 31 + 7, 1), 500)
    c = lexicon.synthetic_lexicon(runtime.rng(2 ** 31 + 8, 1), 500)
    assert a == b and a != c
    assert len(set(a)) == 500 and not set(a) & set(lexicon.TEMPLATE_WORDS)


def test_caption_lengths_are_the_same_multiset_for_every_seed():
    x = lexicon.caption_lengths(2000, 5, 40, 12, 0.4, runtime.rng(1, 10))
    y = lexicon.caption_lengths(2000, 5, 40, 12, 0.4, runtime.rng(2, 10))
    assert sorted(x) == sorted(y) and list(x) != list(y)
    assert x.min() >= 5 and x.max() <= 40
    assert np.median(x) == 12
    assert 12 < x.mean() < 14


def test_captions_are_zipf_skewed_and_seeded():
    lex = lexicon.synthetic_lexicon(runtime.rng(3, 1), 1000)
    lens = [12] * 3000
    caps = lexicon.captions(runtime.rng(3, 11), lex, lens)
    assert caps == lexicon.captions(runtime.rng(3, 11), lex, lens)
    words = [w.rstrip(".") for c in caps for w in c.split()[1:]]
    counts = {w: words.count(w) for w in lex[:20]}
    assert counts[lex[0]] > 5 * counts[lex[19]]
    assert all(c.startswith("a ") and c.endswith(".") for c in caps)


def test_arrivals_are_poisson_at_the_rate_within_the_window():
    rate, seconds = 200.0, 10.0
    n = int(rate * seconds)
    t = serve_text.arrivals(n, rate, seconds, runtime.rng(5, 12))
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert t[-1] < seconds and np.all(gaps >= 0)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.02)
    assert np.std(gaps) == pytest.approx(1 / rate, rel=0.1)
    u = serve_text.arrivals(n, rate, seconds, runtime.rng(6, 12))
    assert sorted(np.diff(np.concatenate([[0.0], u]))) == \
        pytest.approx(sorted(gaps))


def test_corpus_terms_are_distinct_zipf_and_seeded():
    import torch

    from portbench.kinds.serve_text import make_corpus
    from portbench.core import RunContext

    mix = {"corpus": {"docs": 300, "doc_terms": 16, "weight_mu": 0.5,
                      "weight_sigma": 0.6}}
    ctx = RunContext({}, {}, {}, mix, {}, 77, 1.0, False, "cpu", 0.0)
    ids = torch.arange(100, 1100)
    a = make_corpus(ctx, ids, 8)
    b = make_corpus(ctx, ids, 8)
    assert torch.equal(a.doc_terms, b.doc_terms)
    assert torch.equal(a.rows, b.rows)
    for row in a.doc_terms:
        assert len(set(row.tolist())) == 16
    hits = torch.bincount(a.doc_terms.flatten() - 100, minlength=1000)
    assert hits[:10].sum() > 5 * hits[-10:].sum()
    assert a.doc_weights.min() >= 1
    assert torch.allclose(a.rows.norm(dim=1), torch.ones(300))
