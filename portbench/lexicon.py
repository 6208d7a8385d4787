"""The drawn tokenizer and the caption draws.

Neither family's real ``tokenizer.json`` is in the repository, so captions
are tokenized by the port's ``WordPieceLiteTokenizer`` over a lexicon of
pseudo-words drawn from the seed (``chip_smoke.py``'s stand-in), with the
chat families' special tokens as single ids after its vocabulary
(``ChatTokenizer``, a copy of ``chip_smoke.ChatTokenizer``). The prompt
template's own words are pieces of the vocabulary, as they are of a real
one, so a template costs a few tokens a word, not a character each.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

CHAT_SPECIALS = ("<|im_start|>", "<|im_end|>", "<|vision_start|>",
                 "<|vision_end|>", "<|image_pad|>", "<img>", "</img>",
                 "<IMG_CONTEXT>")
# the words of the families' text and image prompts (models/templates.py)
TEMPLATE_WORDS = ("system", "you", "are", "a", "helpful", "assistant",
                  "user", "summary", "above", "sentence", "image", "in",
                  "one", "word")
SYLLABLES = [c + v for c in "bcdfghklmnprstvwz" for v in "aeiou"]


def synthetic_lexicon(rng: np.random.Generator, n: int) -> List[str]:
    """``n`` distinct lowercase pseudo-words of two or three syllables,
    none of them a template word."""
    words, seen = [], set(TEMPLATE_WORDS)
    while len(words) < n:
        k = int(rng.integers(2, 4))
        w = "".join(rng.choice(SYLLABLES, size=k))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def zipf_p(n: int) -> np.ndarray:
    """Probabilities ``1 / rank``, normalised (``tools/common.zipf_p``)."""
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


class ChatTokenizer:
    """A tokenizer with ``specials`` as single ids after ``base``'s own
    vocabulary, as a Hugging Face tokenizer's added tokens are; the text
    between them goes through ``base``."""

    def __init__(self, base, specials: Sequence[str] = CHAT_SPECIALS):
        self.base = base
        self.special_ids = {t: base.vocab_size + i
                            for i, t in enumerate(specials)}
        self._split = re.compile("(" + "|".join(map(re.escape, specials))
                                 + ")")
        self.pad_id = base.pad_id

    def get_vocab(self):
        return {**self.base.get_vocab(), **self.special_ids}

    @property
    def vocab_size(self):
        return self.base.vocab_size + len(self.special_ids)

    def encode(self, text, add_special_tokens=True):
        ids = [self.base.bos_id] if add_special_tokens else []
        for part in self._split.split(text):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
            elif part:
                ids.extend(self.base.encode(part, add_special_tokens=False))
        return ids

    def pad_batch(self, batch, max_len=None, pad_to_multiple=8):
        return self.base.pad_batch(batch, max_len, pad_to_multiple)


def vocabulary_words(lexicon: Sequence[str]) -> List[str]:
    """The words the tokenizer's vocabulary is built from."""
    return list(lexicon) + list(TEMPLATE_WORDS)


def build_tokenizer(lexicon: Sequence[str]) -> ChatTokenizer:
    from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
        WordPieceLiteTokenizer)

    return ChatTokenizer(WordPieceLiteTokenizer(vocabulary_words(lexicon)))


def caption_lengths(n: int, lo: int, hi: int, median: float, sigma: float,
                    rng: np.random.Generator) -> np.ndarray:
    """``n`` caption lengths in words: the quantiles ``(i + 0.5) / n`` of a
    lognormal of ``median`` and ``sigma``, rounded and clipped to
    ``[lo, hi]``, in an order drawn from ``rng``. Every seed gets the same
    lengths; only their order and words differ."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.clip(np.rint(median * np.exp(sigma * z)), lo, hi)
    return rng.permutation(lens.astype(np.int64))


def captions(rng: np.random.Generator, lexicon: Sequence[str],
             lengths: Sequence[int]) -> List[str]:
    """One caption a length: ``a`` and Zipf-drawn lexicon words, ending
    in a period (one bulk draw)."""
    lengths = np.asarray(lengths, np.int64)
    words = rng.choice(len(lexicon), size=int(lengths.sum()),
                       p=zipf_p(len(lexicon)))
    ends = np.cumsum(lengths)
    return ["a " + " ".join(lexicon[w] for w in words[e - k:e]) + "."
            for k, e in zip(lengths, ends)]
