"""Self-contained caption tokenization: Treebank-style word tokenizer + stopwords.

The reference extracts the candidate term set for text sparse vectors with
``nltk.word_tokenize(text.lower())`` filtered by NLTK English stopwords and
``string.punctuation`` (reference src/encode.py:96-103). This module
reimplements that behavior without NLTK's downloadable data files (which are
not shippable in a hermetic image): a Penn-Treebank-convention word
tokenizer and the standard English stopword list, both pure host Python.

Known intentional deviations from NLTK (documented, not observed on the
Karpathy caption corpora):
- sentence splitting uses a regex boundary (``[.!?] + whitespace``) instead of
  the statistical punkt model;
- rare abbreviation-period cases may split differently.
"""

from __future__ import annotations

import re
import string
from typing import FrozenSet, List

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
