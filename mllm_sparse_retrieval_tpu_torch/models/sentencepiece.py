"""A sentencepiece ``tokenizer.model`` as the ``tokenizer.json`` that
``transformers`` would make of it, without ``sentencepiece``, ``protobuf``
or ``transformers``.

The original Vicuna, LLaVA-1.5 and LLaVA-1.6-Vicuna repositories ship
``tokenizer.model`` alone. The JAX package loads them through
``transformers.AutoTokenizer``, which converts the sentencepiece model into
a fast tokenizer (``convert_slow_tokenizer.LlamaConverter`` with
``LlamaTokenizerFast``'s own additions) and writes that as
``tokenizer.json`` when the converter saves the directory. The port does the
same in two steps, and ``hf_tokenizer.HFJsonTokenizer`` then reads the dict
with the BPE, Metaspace, Prepend and Replace code it has:

- ``read_model``: the ``ModelProto`` from the protobuf wire format, read
  with the standard library (neither machine has ``sentencepiece``, and
  the card's has no ``protobuf``). Field numbers and defaults are those of
  ``sentencepiece_model.proto`` (as ``transformers`` bundles it in
  ``utils/sentencepiece_model_pb2_new.py``): the pieces (piece 1, score 2,
  type 3), ``trainer_spec`` (2: ``model_type`` 3, ``byte_fallback`` 35,
  ``unk_id`` 40, ``bos_id`` 41, ``eos_id`` 42, ``pad_id`` 43, ``unk_piece``
  45) and ``normalizer_spec`` (3: ``name`` 1, ``add_dummy_prefix`` 3,
  ``remove_extra_whitespaces`` 4).
- ``llama_tokenizer_json``: the BPE model (the Llama-2 / Vicuna kind) as
  ``LlamaConverter`` builds it: the vocab from the pieces, the merges in
  ``generate_merges``' order (every split of a piece into two pieces,
  ordered by the piece's score), ``byte_fallback`` and ``fuse_unk`` on, the
  unknown piece; the normalizer and pre-tokenizer that ``legacy`` and
  ``add_prefix_space`` in ``tokenizer_config.json`` choose; the decoder;
  the BOS / EOS post-processor of ``add_bos_token`` / ``add_eos_token``;
  and the added tokens in the order ``transformers`` adds them (control
  and user-defined pieces, then ``added_tokens_decoder``, then the special
  tokens), ids and flags as ``tokenizers`` assigns them. A legacy
  ``added_tokens.json`` (content to id) stands for ``added_tokens_decoder``
  where the config has none, as ``from_pretrained`` reads it.

The Unigram model type (and word or char models) raises
``NotImplementedError`` naming it: no family the repo supports ships one.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    _LLAMA_DEFAULTS, _SPECIAL_ATTRS)

# ModelProto.SentencePiece.Type's normal, control and user-defined pieces,
# and TrainerSpec.ModelType
NORMAL, CONTROL, USER_DEFINED = 1, 3, 4
MODEL_TYPES = {1: "Unigram", 2: "BPE", 3: "Word", 4: "Char"}
# the special tokens the slow LlamaTokenizer turns into AddedTokens
# (normalized off, special) when the config gives them as strings
_LLAMA_ADDED = ("bos_token", "eos_token", "unk_token", "pad_token")
_FLAGS = ("single_word", "lstrip", "rstrip", "normalized", "special")


@dataclass
class SentencePieceModel:
    """The fields of a ``ModelProto`` the conversion reads, proto2 defaults
    where the file leaves a field out."""
    pieces: List[Tuple[str, float, int]] = field(default_factory=list)
    model_type: int = 1
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    normalizer_name: str = ""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True


# ---------------------------------------------------------------- the wire

def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """``(field number, value)`` of a message: an int for a varint, bytes
    for a length-delimited field or a fixed 32 / 64-bit one."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            size, i = _varint(buf, i)
            value, i = buf[i:i + size], i + size
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"tokenizer.model: wire type {wire} of field "
                             f"{number} (a proto2 group) is not read")
        yield number, value


def _int32(v: int) -> int:
    """A varint read as int32 (negative ones are ten-byte two's
    complement)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def read_model(data: bytes) -> SentencePieceModel:
    """Parse a serialized ``ModelProto``."""
    m = SentencePieceModel()
    for number, value in _fields(data):
        if number == 1:                                  # pieces
            piece, score, kind = "", 0.0, NORMAL
            for n, v in _fields(value):
                if n == 1:
                    piece = v.decode("utf-8")
                elif n == 2:
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    kind = v
            m.pieces.append((piece, score, kind))
        elif number == 2:                                # trainer_spec
            for n, v in _fields(value):
                if n == 3:
                    m.model_type = v
                elif n == 35:
                    m.byte_fallback = bool(v)
                elif n in (40, 41, 42, 43):
                    setattr(m, {40: "unk_id", 41: "bos_id", 42: "eos_id",
                                43: "pad_id"}[n], _int32(v))
                elif n == 45:
                    m.unk_piece = v.decode("utf-8")
        elif number == 3:                                # normalizer_spec
            for n, v in _fields(value):
                if n == 1:
                    m.normalizer_name = v.decode("utf-8")
                elif n == 3:
                    m.add_dummy_prefix = bool(v)
                elif n == 4:
                    m.remove_extra_whitespaces = bool(v)
    return m


def read_model_file(path: str) -> SentencePieceModel:
    with open(path, "rb") as f:
        return read_model(f.read())


# ----------------------------------------------------------- conversion

def generate_merges(vocab: Dict[str, int],
                    vocab_scores: List[Tuple[str, float]]
                    ) -> List[Tuple[str, str]]:
    """``convert_slow_tokenizer.generate_merges`` with scores: every split
    of a piece into two pieces of ``vocab`` (ordered by their ids), then
    all of them by the piece's score, the left and the right part's
    lengths, each descending (a stable sort)."""
    merges = []
    for piece, score in dict(vocab_scores).items():
        local = [(piece[:k], piece[k:], score) for k in range(1, len(piece))
                 if piece[:k] in vocab and piece[k:] in vocab]
        local.sort(key=lambda x: (vocab[x[0]], vocab[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda x: (x[2], len(x[0]), len(x[1])), reverse=True)
    return [(a, b) for a, b, _ in merges]


def _token(value) -> Optional[dict]:
    """A config's special token (a string or an AddedToken dict) as flags,
    or None."""
    if value is None:
        return None
    if isinstance(value, str):
        return dict(content=value, single_word=False, lstrip=False,
                    rstrip=False, normalized=False, special=True)
    flags = {k: bool(value.get(k, False)) for k in _FLAGS}
    # an AddedToken is normalized unless special, where the dict is silent
    flags["normalized"] = bool(value.get("normalized", not flags["special"]))
    return dict(content=value["content"], **flags)


def _special_contents(config: dict, defaults: dict) -> set:
    """The contents of a config's special tokens (``defaults`` for those it
    leaves out) and of its additional special tokens."""
    toks = [_token(config.get(n, defaults.get(n))) for n in _SPECIAL_ATTRS]
    toks += [_token(t) for t in config.get("additional_special_tokens") or []]
    return {t["content"] for t in toks if t is not None}


def _init_kwargs(config: dict, special_tokens_map: dict,
                 added_tokens: dict) -> dict:
    """The config as ``from_pretrained`` hands it to the tokenizer class:
    without ``added_tokens_decoder``, ``special_tokens_map.json``'s values
    replace the config's and ``added_tokens.json``'s tokens (``content ->
    id``) make the decoder, special where a special token of the result
    has their content, else normalized (the legacy route); with it, a
    special token whose content it lists takes that entry's flags."""
    init = dict(config)
    if "added_tokens_decoder" not in init:
        for key, value in special_tokens_map.items():
            if isinstance(value, dict):
                value = dict(value, special=True)
            elif key == "additional_special_tokens" and \
                    isinstance(value, list):
                extra = list(init.get("additional_special_tokens") or [])
                extra += [dict(t, special=True) if isinstance(t, dict) else t
                          for t in value if t not in extra]
                value = extra
            init[key] = value
        if added_tokens:
            special = _special_contents(init, {})
            init["added_tokens_decoder"] = {
                str(i): dict(content=c, single_word=False, lstrip=False,
                             rstrip=False, normalized=c not in special,
                             special=c in special)
                for c, i in added_tokens.items()}
            return init
    listed = {t["content"]: t for t in
              (init.get("added_tokens_decoder") or {}).values()}
    for key in _SPECIAL_ATTRS:
        tok = _token(init.get(key))
        if listed and tok is not None and tok["content"] in listed:
            init[key] = listed[tok["content"]]
    return init


class _AddedTokens:
    """``tokenizers``' AddedVocabulary.add_tokens: a token whose content is
    in the model's vocab takes that id, a known one keeps its id and takes
    the new flags, a new one takes the next id past the vocab."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.tokens: Dict[str, dict] = {}

    def add(self, tok: dict) -> None:
        known = self.tokens.get(tok["content"])
        if known is not None:
            tid = known["id"]
        elif tok["content"] in self.vocab:
            tid = self.vocab[tok["content"]]
        else:
            top = max((t["id"] for t in self.tokens.values()), default=-1)
            tid = top + 1 if top >= len(self.vocab) else len(self.vocab)
        self.tokens[tok["content"]] = dict(id=tid, content=tok["content"],
                                           **{k: tok[k] for k in _FLAGS})

    def listed(self) -> List[dict]:
        return sorted(self.tokens.values(), key=lambda t: t["id"])


def _template(bos: Optional[dict], eos: Optional[dict], ids: Dict[str, int]
              ) -> dict:
    """``LlamaTokenizerFast.update_post_processor``'s TemplateProcessing."""
    def special(tok, type_id):
        return {"SpecialToken": {"id": tok["content"], "type_id": type_id}}

    def seq(name, type_id):
        return {"Sequence": {"id": name, "type_id": type_id}}

    single = ([special(bos, 0)] if bos else []) + [seq("A", 0)] + (
        [special(eos, 0)] if eos else [])
    pair = single + ([special(bos, 1)] if bos else []) + [seq("B", 1)] + (
        [special(eos, 1)] if eos else [])
    tokens = {t["content"]: {"id": t["content"], "ids": [ids[t["content"]]],
                             "tokens": [t["content"]]}
              for t in (bos, eos) if t}
    return {"type": "TemplateProcessing", "single": single, "pair": pair,
            "special_tokens": tokens}


def llama_tokenizer_json(model: SentencePieceModel,
                         config: Optional[dict] = None,
                         special_tokens_map: Optional[dict] = None,
                         added_tokens: Optional[dict] = None) -> dict:
    """The ``tokenizer.json`` dict that ``AutoTokenizer.from_pretrained``
    builds from a BPE ``tokenizer.model``, its ``tokenizer_config.json``
    (``config``), ``special_tokens_map.json`` and ``added_tokens.json``
    (``added_tokens``) for the Llama tokenizer classes."""
    config = _init_kwargs(config or {}, special_tokens_map or {},
                          added_tokens or {})
    kind = MODEL_TYPES.get(model.model_type, str(model.model_type))
    if kind != "BPE":
        raise NotImplementedError(
            f"tokenizer.model of the {kind} model type: the port converts "
            f"the BPE type (the Llama-2 / Vicuna tokenizer) only")
    legacy = config.get("legacy")
    legacy = True if legacy is None else legacy
    prefix = config.get("add_prefix_space", True)

    # LlamaConverter.vocab: the first three pieces as the tokenizer names
    # its ids 0-2 (their pieces), every score as the file has it
    vocab_scores = [(p, 0.0 if i < 3 else s)
                    for i, (p, s, _) in enumerate(model.pieces)]
    vocab = {p: i for i, (p, _) in enumerate(vocab_scores)}
    merges = generate_merges({p: i for i, (p, _, _) in
                              enumerate(model.pieces)}, vocab_scores)

    added = _AddedTokens(vocab)
    for piece, _, kind in model.pieces:          # the converter's
        if kind in (CONTROL, USER_DEFINED):
            added.add(dict(content=piece, single_word=False, lstrip=False,
                           rstrip=False, normalized=False,
                           special=kind == CONTROL))
    # LlamaTokenizerFast's own: added_tokens_decoder entries not already
    # there with the same flags (special too where a special token has
    # their content), then the special tokens
    have = {tuple(t[k] for k in ("content",) + _FLAGS)
            for t in added.tokens.values()}
    special = _special_contents(config, _LLAMA_DEFAULTS)
    decoder = config.get("added_tokens_decoder") or {}
    for index in sorted(decoder, key=int):
        tok = _token(decoder[index])
        if tuple(tok[k] for k in ("content",) + _FLAGS) not in have:
            tok["special"] = tok["special"] or tok["content"] in special
            added.add(tok)
    specials, seen = {}, set()
    for name in _SPECIAL_ATTRS:
        value = config.get(name, _LLAMA_DEFAULTS.get(name))
        tok = _token(value)
        if tok is not None:
            tok["special"] = True
            specials[name] = tok
            if tok["content"] not in seen:
                seen.add(tok["content"])
                # the slow tokenizer made AddedTokens of these (always
                # added again); other string tokens only when new
                if name in _LLAMA_ADDED or not isinstance(value, str) or \
                        tok["content"] not in added.tokens:
                    added.add(tok)
    for value in config.get("additional_special_tokens") or []:
        tok = dict(_token(value), special=True)
        if tok["content"] not in seen:
            seen.add(tok["content"])
            if not isinstance(value, str) or tok["content"] not in \
                    added.tokens:
                added.add(tok)

    if legacy:
        normalizer = {"type": "Sequence", "normalizers": (
            [{"type": "Prepend", "prepend": "▁"}] if prefix else []) + [
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]}
        pre_tokenizer = None
    else:
        normalizer = None
        pre_tokenizer = {"type": "Metaspace", "replacement": "▁",
                         "prepend_scheme": "first" if prefix else "never",
                         "split": False}
    decoders = [{"type": "Replace", "pattern": {"String": "▁"},
                 "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if prefix:
        decoders.append({"type": "Strip", "content": " ", "start": 1,
                         "stop": 0})
    ids = dict(vocab)
    ids.update({t["content"]: t["id"] for t in added.listed()})
    bos = specials.get("bos_token") if config.get("add_bos_token", True) \
        else None
    eos = specials.get("eos_token") if config.get("add_eos_token", False) \
        else None
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added.listed(),
        "normalizer": normalizer, "pre_tokenizer": pre_tokenizer,
        "post_processor": _template(bos, eos, ids),
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": model.unk_piece,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
