"""Text rules of the reference: frozen copies of what the port derives
from a caption before its model runs.

- the word-piece vocabulary and its greedy longest-match encoding
  (``models/tokenizer.WordPieceLiteTokenizer``), with the chat specials as
  single ids after it (the benchmark's ``ChatTokenizer``);
- the families' prompt strings (``models/templates.py``) and right padding
  to a fixed length;
- the caption's candidate words (``data/tokenization.caption_words``:
  Treebank-style word splitting without NLTK's data files, English
  stopwords and punctuation dropped).
"""

from __future__ import annotations

import re
import string
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

# The standard English stopword list used by NLTK's `stopwords.words('english')`.
ENGLISH_STOPWORDS: FrozenSet[str] = frozenset("""
i me my myself we our ours ourselves you you're you've you'll you'd your yours
yourself yourselves he him his himself she she's her hers herself it it's its
itself they them their theirs themselves what which who whom this that that'll
these those am is are was were be been being have has had having do does did
doing a an the and but if or because as until while of at by for with about
against between into through during before after above below to from up down
in out on off over under again further then once here there when where why how
all any both each few more most other some such no nor not only own same so
than too very s t can will just don don't should should've now d ll m o re ve
y ain aren aren't couldn couldn't didn didn't doesn doesn't hadn hadn't hasn
hasn't haven haven't isn isn't ma mightn mightn't mustn mustn't needn needn't
shan shan't shouldn shouldn't wasn wasn't weren weren't won won't wouldn
wouldn't
""".split())

PUNCTUATION: FrozenSet[str] = frozenset(string.punctuation)

# Tokens dropped from sparse-term candidates: stopwords + single punctuation,
# mirroring `set(stopwords.words('english') + list(string.punctuation))`
# (reference src/encode.py:97).
STOP_SET: FrozenSet[str] = ENGLISH_STOPWORDS | PUNCTUATION


# ---------------------------------------------------------------------------
# Treebank-convention word tokenizer (rule-compatible with the Penn Treebank
# sed script that NLTK's TreebankWordTokenizer follows).
# ---------------------------------------------------------------------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # Sentence-final period (keeps abbreviation periods attached mid-sentence).
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = [
    (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> "),
    (re.compile(r"--"), r" -- "),
]

_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS = [
    re.compile(r"(?i)\b(can)(not)\b"),
    re.compile(r"(?i)\b(d)('ye)\b"),
    re.compile(r"(?i)\b(gim)(me)\b"),
    re.compile(r"(?i)\b(gon)(na)\b"),
    re.compile(r"(?i)\b(got)(ta)\b"),
    re.compile(r"(?i)\b(lem)(me)\b"),
    re.compile(r"(?i)\b(mor)('n)\b"),
    re.compile(r"(?i)\b(wan)(na)(?=\s)"),
]

_SENT_BOUNDARY = re.compile(r"(?<=[.!?])\s+")


def _treebank_tokenize_sentence(text: str) -> List[str]:
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PARENS_BRACKETS:
        text = regexp.sub(substitution, text)
    # Add extra space for ending-quote context rules.
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def word_tokenize(text: str) -> List[str]:
    """Tokenize like ``nltk.word_tokenize``: sentence split, then Treebank rules."""
    tokens: List[str] = []
    for sent in _SENT_BOUNDARY.split(text):
        if sent:
            tokens.extend(_treebank_tokenize_sentence(sent))
    return tokens


def caption_words(text: str) -> List[str]:
    """Candidate content words of a caption for sparse-term selection.

    Equivalent to the reference's
    ``[w for w in word_tokenize(text.lower()) if w not in stopwords+punct]``
    (reference src/encode.py:97).
    """
    return [w for w in word_tokenize(text.lower()) if w not in STOP_SET]


# ---- the word-piece vocabulary ----------------------------------------------

SPECIALS = ("<pad>", "<s>", "</s>", "<unk>", "<image>")
ALPHABET = set("abcdefghijklmnopqrstuvwxyz0123456789.,:!?'\"()- \n")


class WordPieces:
    """The vocabulary a word list gives and its greedy encoding, with the
    chat ``specials`` as single ids after it."""

    def __init__(self, words: Sequence[str], specials: Sequence[str]):
        pieces = list(SPECIALS)
        for c in sorted({c for w in words for c in w} | ALPHABET):
            if c != " ":
                pieces += ["\u2581" + c, c]
        freq: Dict[str, int] = {}
        for w in words:
            w = w.strip()
            if w:
                freq[w] = freq.get(w, 0) + 1
        seen = set(pieces)
        for w, _ in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])):
            if "\u2581" + w not in seen:
                seen.add("\u2581" + w)
                pieces.append("\u2581" + w)
        self.ids = {p: i for i, p in enumerate(pieces)}
        self.longest = max(len(p) for p in pieces)
        self.special_ids = {t: len(pieces) + i for i, t in enumerate(specials)}
        self._split = re.compile("(" + "|".join(map(re.escape, specials))
                                 + ")")
        self.pad_id, self.bos_id = 0, 1

    def _word(self, piece: str) -> List[int]:
        out, pos = [], 0
        while pos < len(piece):
            for end in range(min(len(piece), pos + self.longest), pos, -1):
                if piece[pos:end] in self.ids:
                    out.append(self.ids[piece[pos:end]])
                    pos = end
                    break
            else:
                out.append(self.ids["<unk>"])
                pos += 1
        return out

    def _plain(self, text: str) -> List[int]:
        out = []
        for chunk in text.split("\n"):
            for word in chunk.lower().split(" "):
                if word == "<image>":
                    out.append(self.ids["<image>"])
                elif word:
                    out += self._word("\u2581" + word)
        return out

    def encode(self, text: str, bos: bool = True) -> List[int]:
        out = [self.bos_id] if bos else []
        for part in self._split.split(text):
            if part in self.special_ids:
                out.append(self.special_ids[part])
            elif part:
                out += self._plain(part)
        return out


def candidate_ids(caption: str, vocab: WordPieces) -> np.ndarray:
    """Sorted distinct ids of the caption's candidate words."""
    ids = set()
    for w in caption_words(caption):
        ids.update(vocab.encode(w, bos=False))
    return np.array(sorted(ids), np.int64)


def right_pad(rows: Sequence[Sequence[int]], length: int, pad_id: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows cut to ``length`` and right-padded: (ids, mask) ``[B, length]``."""
    ids = np.full((len(rows), length), pad_id, np.int64)
    mask = np.zeros((len(rows), length), np.int64)
    for i, r in enumerate(rows):
        r = list(r)[:length]
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


# ---- prompts ------------------------------------------------------------------

_TEXT_BODY = "<sent>\nSummary above sentence in one word: "
_IMAGE_BODY = "<image>\nSummary above image in one word: "
WRAPPERS = {
    "QWEN2_5_VL": ("<|im_start|>system\nYou are a helpful assistant."
                   "<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
                   "<|im_start|>assistant\n"),
    "INTERNVL2_5": "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n",
}
IMAGE_WRAP = {
    "QWEN2_5_VL": ("<|vision_start|>", "<|image_pad|>", "<|vision_end|>"),
    "INTERNVL2_5": ("<img>", "<IMG_CONTEXT>", "</img>"),
}


def text_prompt(template: str, caption: str) -> str:
    return WRAPPERS[template].format(_TEXT_BODY).replace("<sent>", caption)


def image_prompt(template: str, n_tokens: int) -> str:
    open_, tok, close = IMAGE_WRAP[template]
    return WRAPPERS[template].format(_IMAGE_BODY).replace(
        "<image>", open_ + tok * n_tokens + close, 1)
