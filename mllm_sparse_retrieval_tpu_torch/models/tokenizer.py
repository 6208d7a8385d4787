"""Tokenizers (a copy of the JAX package's ``models/tokenizer.py``).

``WordPieceLiteTokenizer`` is a deterministic greedy longest-match subword
tokenizer over a vocabulary built from a caption corpus, using the
SentencePiece ``▁`` word-boundary convention so that the filtered-id and
term-string logic (sparse/term_selection.py) behaves as with a real Llama
vocabulary. The pipeline needs of a tokenizer: ``get_vocab()``,
``encode(text, add_special_tokens)``, ``pad_batch`` and ``vocab_size``.
``HFTokenizerAdapter`` gives a HuggingFace tokenizer, which a converted
checkpoint may ship, that interface; it imports nothing itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np


class Tokenizer(Protocol):
    """What the pipelines read of a tokenizer (the JAX package's
    ``Tokenizer``); ``WordPieceLiteTokenizer`` and ``HFTokenizerAdapter``
    give it."""

    pad_id: int

    def get_vocab(self) -> Dict[str, int]: ...

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]: ...

    @property
    def vocab_size(self) -> int: ...


def pad_id_batch(batch: Sequence[Sequence[int]], pad_id: int,
                 max_len: Optional[int] = None, pad_to_multiple: int = 8):
    """Right-pad a batch of id lists; returns (ids [B,T], mask [B,T]).

    WARNING: rows longer than ``max_len`` are truncated. Never train with a
    ``max_len`` shorter than the full prompt unless encode-time inputs are
    truncated identically — representations are read at the last non-pad
    token, so a cut prompt trains different reps than it serves.
    """
    longest = max((len(x) for x in batch), default=1)
    target = max_len if max_len is not None else longest
    target = -(-target // pad_to_multiple) * pad_to_multiple
    ids = np.full((len(batch), target), pad_id, dtype=np.int32)
    mask = np.zeros((len(batch), target), dtype=np.int32)
    for i, row in enumerate(batch):
        row = list(row)[:target]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask


class WordPieceLiteTokenizer:
    """Greedy longest-match subword tokenizer with ``▁`` word boundaries.

    Vocabulary = specials + ``▁word`` pieces for frequent corpus words +
    ``▁c``/``c`` single-character pieces as the fallback alphabet, mirroring
    the shape (not the contents) of a SentencePiece BPE vocab so token-id
    term selection, filtered ids, and string-collision semantics all behave
    as they do with a real Llama tokenizer.
    """

    PAD, BOS, EOS, UNK, IMAGE = "<pad>", "<s>", "</s>", "<unk>", "<image>"

    def __init__(self, words: Sequence[str], max_words: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        specials = [self.PAD, self.BOS, self.EOS, self.UNK, self.IMAGE]
        alphabet = sorted(
            {c for w in words for c in w} |
            set("abcdefghijklmnopqrstuvwxyz0123456789.,:!?'\"()- \n"))
        pieces: List[str] = list(specials)
        for c in alphabet:
            if c == " ":
                continue
            pieces.append(f"▁{c}")
            pieces.append(c)
        # frequency-ordered word pieces
        freq: Dict[str, int] = {}
        for w in words:
            w = w.strip()
            if w:
                freq[w] = freq.get(w, 0) + 1
        ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        if max_words is not None:
            ordered = ordered[:max_words]
        for w, _ in ordered:
            piece = f"▁{w}"
            if piece not in pieces:
                pieces.append(piece)
            if vocab_size is not None and len(pieces) >= vocab_size:
                break
        if vocab_size is not None and len(pieces) < vocab_size:
            pieces.extend(f"<extra_{i}>" for i in range(vocab_size - len(pieces)))
        self._vocab: Dict[str, int] = {p: i for i, p in enumerate(pieces)}
        self._pieces = pieces
        self.pad_id = self._vocab[self.PAD]
        self.bos_id = self._vocab[self.BOS]
        self.eos_id = self._vocab[self.EOS]
        self.unk_id = self._vocab[self.UNK]
        self.image_token_id = self._vocab[self.IMAGE]
        # longest-match table keyed by first char for speed
        self._max_piece_len = max(len(p) for p in pieces)

    @classmethod
    def from_corpus_captions(cls, captions: Sequence[str],
                             vocab_size: int = 4096) -> "WordPieceLiteTokenizer":
        words = [w for cap in captions for w in cap.lower().split()]
        cleaned = [w.strip(".,:;!?\"'()") for w in words]
        return cls([w for w in cleaned if w], vocab_size=vocab_size)

    # ---- protocol -------------------------------------------------------
    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab)

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    def id_to_token(self, tid: int) -> str:
        return self._pieces[tid]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_special_tokens else []
        for chunk in text.split("\n"):
            for word in chunk.lower().split(" "):
                if not word:
                    continue
                if word == self.IMAGE:
                    ids.append(self.image_token_id)
                    continue
                ids.extend(self._encode_word("▁" + word))
        return ids

    def _encode_word(self, piece: str) -> List[int]:
        """Greedy longest-prefix-match segmentation."""
        out: List[int] = []
        pos = 0
        while pos < len(piece):
            best = None
            limit = min(len(piece), pos + self._max_piece_len)
            for end in range(limit, pos, -1):
                cand = piece[pos:end]
                if cand in self._vocab:
                    best = cand
                    break
            if best is None:
                out.append(self.unk_id)
                pos += 1
            else:
                out.append(self._vocab[best])
                pos += len(best)
        return out

    def pad_batch(self, batch: Sequence[Sequence[int]], max_len: Optional[int] = None,
                  pad_to_multiple: int = 8):
        return pad_id_batch(batch, self.pad_id, max_len, pad_to_multiple)


class HFTokenizerAdapter:
    """Adapter over a locally available HuggingFace tokenizer."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.pad_id = hf_tokenizer.pad_token_id or 0

    @property
    def hf_tokenizer(self):
        """The HF tokenizer itself: ``templates.resolve_template`` renders
        the Qwen2.5-VL and InternVL2.5 chat templates through it."""
        return self._tok

    def get_vocab(self) -> Dict[str, int]:
        return self._tok.get_vocab()

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def pad_batch(self, batch: Sequence[Sequence[int]],
                  max_len: Optional[int] = None, pad_to_multiple: int = 8):
        return pad_id_batch(batch, self.pad_id, max_len, pad_to_multiple)
