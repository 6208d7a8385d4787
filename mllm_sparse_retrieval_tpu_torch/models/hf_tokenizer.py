"""A reader of Hugging Face ``tokenizer.json`` files, in pure Python.

``HFJsonTokenizer.from_dir(path)`` reads a checkpoint directory's
``tokenizer.json`` with its ``tokenizer_config.json``,
``special_tokens_map.json`` and ``chat_template.jinja`` where present, and
gives the ids that ``transformers.AutoTokenizer.from_pretrained(path)``
gives, with the interface of ``tokenizer.HFTokenizerAdapter``:
``encode(text, add_special_tokens)``, ``get_vocab``, ``vocab_size`` (added
tokens included, as ``len(tok)``), ``pad_id`` and ``pad_batch``; plus
``chat_template`` and ``apply_chat_template``, which renders with
``jinja2`` under the environment ``transformers`` uses. It imports neither
``transformers``, ``tokenizers`` nor ``regex``.

What it covers is what the supported families' tokenizers use:

- normalizers NFC, Prepend, Replace and Sequence;
- pre-tokenizers Split (a string or a regex, behavior Isolated),
  ByteLevel, Metaspace (prepend scheme always / first / never, split or
  not) and Sequence;
- the BPE model with ``byte_fallback``, ``fuse_unk``, ``ignore_merges``
  and an unknown token (no dropout), and the WordLevel model;
- TemplateProcessing, ByteLevel and Sequence post-processors, and the
  BOS / EOS post-processor that ``LlamaTokenizerFast`` rebuilds from
  ``add_bos_token`` / ``add_eos_token`` when it loads;
- added tokens, special or not, split out before normalization (those
  marked ``normalized`` after it, matched against their normalized form),
  with their ``lstrip`` / ``rstrip`` / ``single_word`` flags.

Any other component raises ``NotImplementedError`` naming it. The regexes
are Oniguruma's: ``\\p{L}``-style classes and ``\\s`` are rewritten into
explicit classes built once from ``unicodedata`` (``\\s`` as Unicode
White_Space) and compiled with the standard ``re``. A directory with a
sentencepiece ``tokenizer.model`` and no ``tokenizer.json`` (the original
Vicuna and LLaVA repositories) is read through the ``tokenizer.json`` that
``models/sentencepiece.py`` converts it to, as ``transformers`` does.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence

from mllm_sparse_retrieval_tpu_torch.models.tokenizer import pad_id_batch

# Unicode White_Space: Oniguruma's \s and Rust's char::is_whitespace
_WHITE_SPACE = ("\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a"
                "\\u2028\\u2029\\u202f\\u205f\\u3000")
_WS_SET = frozenset(
    [chr(c) for c in (9, 10, 11, 12, 13, 32, 0x85, 0xA0, 0x1680, 0x2028,
                      0x2029, 0x202F, 0x205F, 0x3000)]
    + [chr(c) for c in range(0x2000, 0x200B)])
_CLASS_CACHE: Dict[str, str] = {}


def _category_class(cat: str) -> str:
    """The body of a character class of every code point whose general
    category starts with ``cat`` (``L``, ``N``, ``Lu``...), as ranges."""
    body = _CLASS_CACHE.get(cat)
    if body is not None:
        return body
    parts, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(cat):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append((start, prev))
            start = None
    if start is not None:
        parts.append((start, prev))

    def esc(cp):
        return re.escape(chr(cp)) if cp > 0x20 else f"\\x{cp:02x}"

    body = "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in parts)
    _CLASS_CACHE[cat] = body
    return body


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json as a Python ``re`` pattern:
    ``\\p{..}`` and ``\\s`` / ``\\S`` become explicit classes, everything
    else is kept."""
    out, i, in_class, n = [], 0, False, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                close = pattern.index("}", i + 3)
                if nxt == "P":
                    raise NotImplementedError(f"\\P{{..}} in {pattern!r}")
                body = _category_class(pattern[i + 3:close])
                out.append(body if in_class else f"[{body}]")
                i = close + 1
                continue
            if nxt == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
                i += 2
                continue
            if nxt == "S":
                if in_class:
                    raise NotImplementedError(
                        f"\\S inside a class in {pattern!r}")
                out.append(f"[^{_WHITE_SPACE}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            i += 1
            # a leading ^ and a literal ] right after [ or [^
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        elif ch == "[" and in_class:
            ch = "\\["
        out.append(ch)
        i += 1
    return "".join(out)


def _compile(pattern: dict) -> "re.Pattern":
    if "Regex" in pattern:
        return re.compile(translate_regex(pattern["Regex"]))
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    raise NotImplementedError(f"pattern {pattern!r}")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHARS = _bytes_to_unicode()
_GPT2_REGEX = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
               r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


# ------------------------------------------------------------ normalizers

def _normalizer(spec: Optional[dict]):
    """A function str -> str, or None."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        rx, content = _compile(spec["pattern"]), spec["content"]
        return lambda s: rx.sub(lambda m: content, s)
    if kind == "Sequence":
        fns = [f for f in (_normalizer(n) for n in spec["normalizers"]) if f]

        def seq(s):
            for f in fns:
                s = f(s)
            return s
        return seq
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r}")


# --------------------------------------------------------- pre-tokenizers
# A pre-tokenizer maps a list of (piece, original start) to a new list.

def _split_pieces(rx, behavior: str, text: str, start: int):
    """tokenizers' NormalizedString.split of ``text`` (at original offset
    ``start``) by a regex's matches: (piece, original start) pairs. Each
    match is a piece of its own (``Isolated``) or opens the next piece
    (``MergedWithNext``, Metaspace's split)."""
    cuts = {0, len(text)}
    for m in rx.finditer(text):
        a, b = m.span()
        if a < b:
            cuts.update((a, b) if behavior == "Isolated" else (a,))
    edges = sorted(cuts)
    return [(text[a:b], start + a) for a, b in zip(edges, edges[1:])
            if b > a]


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        fns = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for f in fns:
                pieces = f(pieces)
            return pieces
        return seq
    if kind == "Split":
        if spec.get("invert") or spec["behavior"] != "Isolated":
            raise NotImplementedError(
                f"Split pre-tokenizer {spec['behavior']} (invert "
                f"{spec.get('invert')}): Isolated only")
        rx = _compile(spec["pattern"])
        return lambda pieces: [q for p, s in pieces
                               for q in _split_pieces(rx, "Isolated", p, s)]
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", False)
        rx = re.compile(translate_regex(_GPT2_REGEX)) \
            if spec.get("use_regex", True) else None

        def byte_level(pieces):
            out = []
            for p, s in pieces:
                if prefix and not p.startswith(" "):
                    p = " " + p
                parts = _split_pieces(rx, "Isolated", p, s) if rx \
                    else [(p, s)]
                out.extend(("".join(_BYTE_CHARS[b] for b in q.encode()), t)
                           for q, t in parts)
            return out
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        split = spec.get("split", True)
        rx = re.compile(re.escape(rep))

        def metaspace(pieces):
            out = []
            for p, s in pieces:
                p = p.replace(" ", rep)
                if not p.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and s == 0)):
                    p = rep + p
                if split:
                    out.extend(_split_pieces(rx, "MergedWithNext", p, s))
                elif p:
                    out.append((p, s))
            return out
        return metaspace
    raise NotImplementedError(f"tokenizer.json pre-tokenizer {kind!r}")


# ------------------------------------------------------------------ BPE

class _BPE:
    """tokenizers' BPE model: ``merge_word`` and ``Word::merge_all``."""

    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise NotImplementedError("BPE dropout")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        if spec.get("continuing_subword_prefix") or \
                spec.get("end_of_word_suffix"):
            raise NotImplementedError("BPE with a continuing-subword prefix "
                                      "or an end-of-word suffix")
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        merges = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"tokenizer.json merge {a!r} {b!r}: "
                                 f"{e.args[0]!r} is not in the vocab") \
                    from None
        self.merges = merges
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_word(word)
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return list(hit)

    def _merge_word(self, w: str) -> List[int]:
        syms: List[int] = []
        unk: Optional[int] = None
        for s in w:
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if all(x is not None for x in ids):
                    syms.extend(ids)
                    continue
            if self.unk is not None:
                unk_id = self.vocab.get(self.unk)
                if unk_id is None:
                    raise ValueError(f"the unknown token {self.unk!r} is not "
                                     f"in the vocab")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        return self._merge_all(syms)

    def _merge_all(self, syms: List[int]) -> List[int]:
        n = len(syms)
        if n < 2:
            return syms
        c = list(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


class _WordLevel:
    """tokenizers' WordLevel model: a pre-token's id, or the unknown
    token's."""

    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> List[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk) if self.unk is not None else None
            if tid is None:
                raise ValueError(f"WordLevel: {word!r} and the unknown "
                                 f"token are not in the vocab")
        return [tid]


# -------------------------------------------------------- post-processors

def _post_processor(spec: Optional[dict]):
    """A function (ids, add_special_tokens) -> ids, or None."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        return None
    if kind == "Sequence":
        fns = [f for f in (_post_processor(p) for p in spec["processors"])
               if f]

        def seq(ids, add):
            for f in fns:
                ids = f(ids, add)
            return ids
        return seq
    if kind == "TemplateProcessing":
        special = {k: v["ids"] for k, v in spec["special_tokens"].items()}
        template = spec["single"]

        def apply(ids, add):
            if not add:
                return ids
            out = []
            for piece in template:
                if "Sequence" in piece:
                    if piece["Sequence"]["id"] != "A":
                        raise ValueError("a single-sequence template names "
                                         "sequence B")
                    out.extend(ids)
                else:
                    out.extend(special[piece["SpecialToken"]["id"]])
            return out
        return apply
    raise NotImplementedError(f"tokenizer.json post-processor {kind!r}")


# --------------------------------------------------------------- reader

def _token_content(value) -> Optional[str]:
    if value is None:
        return None
    if isinstance(value, dict):
        return value.get("content")
    return str(value)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                  "pad_token", "cls_token", "mask_token")
# tokenizer classes whose fast tokenizer rebuilds its post-processor from
# add_bos_token / add_eos_token when it loads (LlamaTokenizerFast)
_LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast",
                  "CodeLlamaTokenizer", "CodeLlamaTokenizerFast")
# LlamaTokenizerFast's defaults for the special tokens a config leaves out
_LLAMA_DEFAULTS = {"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}


def tokenizer_json_of_dir(path: str, config: dict,
                          special_tokens_map: dict) -> dict:
    """A directory's ``tokenizer.json`` dict: the file, else its
    ``tokenizer.model`` converted with the directory's
    ``tokenizer_config.json`` (``config``), ``special_tokens_map.json``
    and a legacy ``added_tokens.json``."""
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        with open(tj, encoding="utf-8") as f:
            return json.load(f)
    spm = os.path.join(path, "tokenizer.model")
    if not os.path.exists(spm):
        raise FileNotFoundError(f"{path}: no tokenizer.json or "
                                f"tokenizer.model")
    from mllm_sparse_retrieval_tpu_torch.models import sentencepiece

    return sentencepiece.llama_tokenizer_json(
        sentencepiece.read_model_file(spm), config, special_tokens_map,
        _read_json(os.path.join(path, "added_tokens.json")))


class HFJsonTokenizer:
    """A checkpoint's ``tokenizer.json``, read without ``tokenizers``."""

    def __init__(self, tokenizer_json: dict, config: Optional[dict] = None,
                 special_tokens_map: Optional[dict] = None,
                 chat_template: Optional[str] = None):
        config = dict(config or {})
        special_tokens_map = special_tokens_map or {}
        self._normalize = _normalizer(tokenizer_json.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(
            tokenizer_json.get("pre_tokenizer"))
        model = tokenizer_json["model"]
        kind = model.get("type", "BPE")
        if kind not in ("BPE", "WordLevel"):
            raise NotImplementedError(
                f"tokenizer.json model {kind!r} (BPE and WordLevel only)")
        self._model = _BPE(model) if kind == "BPE" else _WordLevel(model)
        self._post = _post_processor(tokenizer_json.get("post_processor"))

        vocab = dict(self._model.vocab)
        added = tokenizer_json.get("added_tokens", [])
        for tok in added:
            vocab[tok["content"]] = tok["id"]
        self._vocab = vocab
        self._added = {t["content"]: t for t in added}
        self._raw_rx = self._added_regex(
            [t["content"] for t in added if not t.get("normalized")])
        norm = [t for t in added if t.get("normalized")]
        self._norm_forms = {}
        for t in norm:
            form = self._normalize(t["content"]) if self._normalize \
                else t["content"]
            self._norm_forms.setdefault(form, t)
        self._norm_rx = self._added_regex(list(self._norm_forms))

        # special tokens as transformers resolves them: the config first
        # (special_tokens_map.json first where the config has no
        # added_tokens_decoder: the legacy route), then the class's
        # defaults
        llama = config.get("tokenizer_class") in _LLAMA_CLASSES
        first, then = (config, special_tokens_map) \
            if "added_tokens_decoder" in config \
            else (special_tokens_map, config)
        tokens = {}
        for name in _SPECIAL_ATTRS + ("additional_special_tokens",):
            value = first.get(name, then.get(
                name, _LLAMA_DEFAULTS.get(name) if llama else None))
            if name == "additional_special_tokens":
                if value:
                    tokens[name] = [_token_content(v) for v in value]
            elif _token_content(value) is not None:
                tokens[name] = _token_content(value)
        self.special_tokens_map = tokens
        if llama:
            self._post = self._llama_post_processor(config)
        unk = tokens.get("unk_token")
        unk_id = self._vocab.get(unk) if unk is not None else None
        pad = tokens.get("pad_token")
        pad_id = None
        if pad is not None:
            pad_id = self._vocab.get(pad, unk_id)
        self.pad_id = pad_id or 0
        self.chat_template = chat_template

    # ---- construction -----------------------------------------------------
    @classmethod
    def from_dir(cls, path: str) -> "HFJsonTokenizer":
        """Read a directory's tokenizer files: ``tokenizer.json``, else a
        sentencepiece ``tokenizer.model`` converted as ``transformers``
        converts it (``sentencepiece.llama_tokenizer_json``). Raises
        ``FileNotFoundError`` without either."""
        config = _read_json(os.path.join(path, "tokenizer_config.json"))
        smap = _read_json(os.path.join(path, "special_tokens_map.json"))
        data = tokenizer_json_of_dir(path, config, smap)
        template = config.get("chat_template")
        jinja_file = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_file):
            with open(jinja_file, encoding="utf-8") as f:
                template = f.read()
        elif template is None:
            template = _read_json(os.path.join(
                path, "chat_template.json")).get("chat_template")
        if isinstance(template, list):
            named = {t["name"]: t["template"] for t in template}
            template = named.get("default")
        return cls(data, config, smap, template)

    @staticmethod
    def _added_regex(contents: Sequence[str]):
        if not contents:
            return None
        # longest first: Python's alternation then takes the longest token
        # at the leftmost position (Aho-Corasick LeftmostLongest)
        ordered = sorted(set(contents), key=lambda s: (-len(s), s))
        return re.compile("|".join(re.escape(s) for s in ordered))

    def _llama_post_processor(self, config: dict):
        """LlamaTokenizerFast.update_post_processor: BOS / EOS from
        add_bos_token (default on) and add_eos_token (default off)."""
        add_bos = config.get("add_bos_token", True)
        add_eos = config.get("add_eos_token", False)
        pre = [self._vocab[self.special_tokens_map["bos_token"]]] \
            if add_bos else []
        post = [self._vocab[self.special_tokens_map["eos_token"]]] \
            if add_eos else []
        return lambda ids, add: pre + ids + post if add else ids

    # ---- added-token split (tokenizers' AddedVocabulary.find_matches) -----
    def _find(self, text: str, start: int, rx, by_form: Dict[str, dict]):
        """Split ``text`` (whose first char is at original offset ``start``)
        into (piece, original start, token id or None)."""
        if rx is None or not text:
            return [(text, start, None)] if text else []
        out, offset = [], 0
        for m in rx.finditer(text):
            a, b = m.start(), m.end()
            tok = by_form[m.group()]
            if tok.get("single_word"):
                before = a == 0 or not _is_word_char(text[a - 1])
                after = b == len(text) or not _is_word_char(text[b])
                if not (before and after):
                    continue
            if tok.get("lstrip"):
                k = a
                while k > 0 and text[k - 1] in _WS_SET:
                    k -= 1
                a = max(k, offset)
            if tok.get("rstrip"):
                while b < len(text) and text[b] in _WS_SET:
                    b += 1
            if offset < a:
                out.append((text[offset:a], start + offset, None))
            out.append((text[a:b], start + a, tok["id"]))
            offset = b
        if offset < len(text):
            out.append((text[offset:], start + offset, None))
        return out

    def __repr__(self) -> str:
        return f"HFJsonTokenizer(vocab_size={self.vocab_size})"

    # ---- protocol -------------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids: List[int] = []
        for piece, start, tid in self._find(text, 0, self._raw_rx,
                                            self._added):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self._normalize(piece) if self._normalize else piece
            for sub, s, sub_id in self._find(norm, start, self._norm_rx,
                                             self._norm_forms):
                if sub_id is not None:
                    ids.append(sub_id)
                    continue
                words = self._pre_tokenize([(sub, s)]) \
                    if self._pre_tokenize else [(sub, s)]
                for word, _ in words:
                    ids.extend(self._model.tokenize(word))
        if self._post is not None:
            ids = self._post(ids, add_special_tokens)
        return ids

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab)

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def pad_batch(self, batch: Sequence[Sequence[int]],
                  max_len: Optional[int] = None, pad_to_multiple: int = 8):
        return pad_id_batch(batch, self.pad_id, max_len, pad_to_multiple)

    # ---- chat template ------------------------------------------------------
    def apply_chat_template(self, messages, tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs):
        """Render ``messages`` through the checkpoint's chat template as
        ``transformers`` renders it: ``jinja2``'s
        ``ImmutableSandboxedEnvironment(trim_blocks=True,
        lstrip_blocks=True)`` with loop controls, the ``raise_exception``
        global, the non-escaping ``tojson`` filter and the special-token
        strings as variables. Raises when there is no template or
        ``jinja2`` does not import."""
        if not self.chat_template:
            raise ValueError("this tokenizer has no chat template")
        try:
            import jinja2
            from jinja2.sandbox import ImmutableSandboxedEnvironment
        except ImportError as e:
            raise ImportError(
                "the checkpoint ships a chat template and rendering it "
                "needs jinja2") from e

        def raise_exception(message):
            raise jinja2.exceptions.TemplateError(message)

        def tojson(x, ensure_ascii=False, indent=None, separators=None,
                   sort_keys=False):
            return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                              separators=separators, sort_keys=sort_keys)

        def strftime_now(fmt):
            from datetime import datetime
            return datetime.now().strftime(fmt)

        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True,
            extensions=[jinja2.ext.loopcontrols])
        env.filters["tojson"] = tojson
        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = strftime_now
        rendered = env.from_string(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens_map, **kwargs})
        if tokenize:
            return self.encode(rendered, add_special_tokens=False)
        return rendered


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"
