"""HF tokenizer directories, read without ``tokenizers`` or ``transformers``.

:meth:`Tokenizer.from_pretrained` reads a directory's ``tokenizer.json``
(the pipeline of HF ``tokenizers``: added tokens, normalizer,
pre-tokenizer, model, post-processor, decoder), its
``tokenizer_config.json`` and ``special_tokens_map.json`` (the special
tokens, ``model_max_length``, the padding and truncation sides,
``clean_up_tokenization_spaces``) and its chat template
(``chat_template.jinja``, else the config's entry, else
``chat_template.json``), and offers what ``transformers.AutoTokenizer``
offers the text embedder: ``__call__`` with truncation, padding and
special tokens, ``apply_chat_template`` and ``decode``.

The components are those of the Qwen2.5-VL and CLIP ViT-L/14 files
(normalizers NFC, Replace, Lowercase, Sequence; pre-tokenizers Split
(Isolated or Removed, inverted or not), ByteLevel, Sequence; BPE with its
unk token, word-end suffix and continuation prefix; the ByteLevel and
Roberta post-processors; the ByteLevel decoder), and the word-level ones
HF writes for a ``WordLevel`` model (the Whitespace pre-tokenizer,
TemplateProcessing, no decoder). Any other component or option raises and
names itself.

``tokenizers`` compiles its patterns with Oniguruma; stdlib ``re`` takes
them here after ``\\p{L}``, ``\\p{N}``, ``\\s``, ``\\w`` and ``\\d`` are
rewritten as explicit classes with Oniguruma's Unicode meanings, built from
``unicodedata`` (Python's own ``\\s`` and ``\\w`` differ from them).
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

# Oniguruma's Unicode classes: general-category prefixes, plus code points
_CLASSES = {
    "L": (("L",), ""),
    "N": (("N",), ""),
    "s": (("Zs", "Zl", "Zp"), "\t\n\x0b\x0c\r\x85"),
    "w": (("L", "M", "N", "Pc"), ""),
}
_NEGATED = {"S": "s", "W": "w"}


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


@lru_cache(maxsize=None)
def _class_body(key: str) -> str:
    """The inside of a character class for Oniguruma's ``key`` class."""
    cats, extra = _CLASSES[key]
    cps = sorted({ord(c) for c in extra} | {
        cp for cp in range(0x110000)
        if unicodedata.category(chr(cp)).startswith(cats)})
    parts, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        parts.append(_esc(cps[i]) if i == j else f"{_esc(cps[i])}-{_esc(cps[j])}")
        i = j + 1
    return "".join(parts)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer file as a stdlib ``re`` pattern:
    ``\\p{L}``, ``\\p{N}``, ``\\s``, ``\\w`` (and ``\\S``, ``\\W``
    outside a class) become explicit classes; every other escape and
    construct passes as written. A nested class, a negated class escape
    inside a class or another property raises."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\^?)([LN])\}", pattern[i + 2:])
                if m is None:
                    raise ValueError(f"tokenizer pattern {pattern!r}: unknown "
                                     f"property at {pattern[i:i + 12]!r}")
                neg = (e == "P") != bool(m.group(1))
                key = m.group(2)
                i += 2 + m.end()
            elif e in _CLASSES:
                neg, key = False, e
                i += 2
            elif e in _NEGATED:
                neg, key = True, _NEGATED[e]
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            body = _class_body(key)
            if in_class:
                if neg:
                    raise ValueError(f"tokenizer pattern {pattern!r}: a "
                                     "negated class escape inside a class")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[":
            if in_class:
                raise ValueError(f"tokenizer pattern {pattern!r}: a nested "
                                 "character class")
            in_class = True
            out.append(c)
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):
                raise ValueError(f"tokenizer pattern {pattern!r}: a class "
                                 "that starts with ']'")
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _pattern(spec, where: str):
    """A compiled pattern from a ``{"Regex": ...}`` entry."""
    if isinstance(spec, dict) and set(spec) == {"Regex"}:
        return re.compile(translate_pattern(spec["Regex"]))
    raise ValueError(f"tokenizer: {where} has the pattern {spec!r}")


def _unknown(kind: str, spec) -> ValueError:
    return ValueError(f"tokenizer: the {kind} {spec.get('type')!r} is not "
                      f"implemented here ({json.dumps(spec)[:200]})")


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes onto printable characters (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# the regex of the Whitespace pre-tokenizer
_WHITESPACE_SPLIT = r"\w+|[^\w\s]+"


def _split(regex, text: str, keep_matches: bool, keep_gaps: bool) -> List[str]:
    """The non-empty matches and gaps of ``regex`` over ``text``, in order,
    each kept or dropped."""
    out, prev = [], 0
    for m in regex.finditer(text):
        if m.start() == m.end():
            continue
        if keep_gaps and m.start() > prev:
            out.append(text[prev:m.start()])
        if keep_matches:
            out.append(m.group())
        prev = m.end()
    if keep_gaps and prev < len(text):
        out.append(text[prev:])
    return out


# ---------------------------------------------------------------------------
# the pipeline's components
# ---------------------------------------------------------------------------

def _lowercase(s: str) -> str:
    """Lowercase character by character, as ``tokenizers`` does (no
    final-sigma rule)."""
    return "".join(c.lower() for c in s) if "Σ" in s else s.lower()


def _normalizer(spec):
    """A str -> str function for a normalizer entry (None: identity)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC" and set(spec) == {"type"}:
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Lowercase" and set(spec) == {"type"}:
        return _lowercase
    if kind == "Replace" and set(spec) == {"type", "pattern", "content"}:
        regex, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda s: regex.sub(lambda _: content, s)
    if kind == "Sequence" and set(spec) == {"type", "normalizers"}:
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s):
            for step in steps:
                s = step(s)
            return s
        return run
    raise _unknown("normalizer", spec)


def _pre_tokenizer(spec):
    """A str -> list of str function for a pre-tokenizer entry."""
    if spec is None:
        return lambda s: [s]
    kind = spec.get("type")
    if kind == "Split" and set(spec) == {"type", "pattern", "behavior", "invert"}:
        regex = _pattern(spec["pattern"], "Split")
        behavior, invert = spec["behavior"], bool(spec["invert"])
        if behavior == "Isolated":
            return lambda s: _split(regex, s, True, True)
        if behavior == "Removed":
            return lambda s: _split(regex, s, invert, not invert)
        raise ValueError(f"tokenizer: Split's behavior {behavior!r} is not "
                         "implemented here")
    if kind == "ByteLevel" and set(spec) <= {"type", "add_prefix_space",
                                             "trim_offsets", "use_regex"}:
        for opt in ("add_prefix_space", "use_regex"):
            if spec.get(opt, True):
                raise ValueError(f"tokenizer: ByteLevel with {opt} is not "
                                 "implemented here")
        table = bytes_to_unicode()
        return lambda s: ["".join(table[b] for b in s.encode("utf-8"))]
    if kind == "Whitespace" and set(spec) == {"type"}:
        regex = re.compile(translate_pattern(_WHITESPACE_SPLIT))
        return lambda s: _split(regex, s, True, False)
    if kind == "Sequence" and set(spec) == {"type", "pretokenizers"}:
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(s):
            pieces = [s]
            for step in steps:
                pieces = [q for p in pieces for q in step(p) if q]
            return pieces
        return run
    raise _unknown("pre-tokenizer", spec)


class _BPE:
    """The BPE model of ``tokenizers``: a word's characters (the first
    without ``continuing_subword_prefix``, the last with
    ``end_of_word_suffix``), merged pair by pair, the lowest rank first and
    of equal ranks the leftmost, as its priority queue does; characters
    outside the vocabulary become ``unk_token``, or are dropped when there
    is none."""

    KEYS = {"type", "dropout", "unk_token", "continuing_subword_prefix",
            "end_of_word_suffix", "fuse_unk", "byte_fallback",
            "ignore_merges", "vocab", "merges"}

    def __init__(self, spec):
        if not set(spec) <= self.KEYS or not {"vocab", "merges"} <= set(spec):
            raise _unknown("model", spec)
        for opt in ("dropout", "byte_fallback", "fuse_unk", "ignore_merges"):
            if spec.get(opt):
                raise ValueError(f"tokenizer: BPE with {opt} is not "
                                 "implemented here")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        if self.unk is not None and self.unk not in self.vocab:
            raise ValueError(f"tokenizer: BPE's unk_token {self.unk!r} is not "
                             "in its vocabulary")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.merges: Dict[tuple, tuple] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ") if isinstance(m, str) else m
            new = a + b[len(self.prefix):]
            if a not in self.vocab or b not in self.vocab or new not in self.vocab:
                raise ValueError(f"tokenizer: the merge {m!r} leaves the "
                                 "vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
        self.cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge(self._symbols(word))
        if len(self.cache) >= 10000:  # bounded, as the HF model's cache
            self.cache.clear()
        self.cache[word] = ids
        return ids

    def _symbols(self, word: str) -> List[int]:
        out = []
        for i, ch in enumerate(word):
            s = ((self.prefix if i else "") + ch
                 + (self.suffix if i == len(word) - 1 else ""))
            if s in self.vocab:
                out.append(self.vocab[s])
            elif self.unk is not None:
                out.append(self.vocab[self.unk])
        return out

    def _merge(self, sym: List[int]) -> List[int]:
        n = len(sym)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        queue = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                queue.append((m[0], i, m[1]))
        heapq.heapify(queue)
        while queue:
            rank, pos, new = heapq.heappop(queue)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue  # an expired entry
            sym[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((sym[prv[pos]], new))
                if m is not None:
                    heapq.heappush(queue, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(queue, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


class _WordLevel:
    def __init__(self, spec):
        if not set(spec) <= {"type", "vocab", "unk_token"}:
            raise _unknown("model", spec)
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def __call__(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk not in self.vocab:
            raise ValueError(f"tokenizer: WordLevel has no unk token for "
                             f"{word!r}")
        return [self.vocab[self.unk]]


def _model(spec):
    kind = spec.get("type")
    if kind == "BPE":
        return _BPE(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    raise _unknown("model", spec)


def _post_processor(spec):
    """(ids -> ids with the special tokens, how many it adds) for a
    post-processor entry, single sequences only."""
    if spec is None or (spec.get("type") == "ByteLevel" and set(spec) <= {
            "type", "add_prefix_space", "trim_offsets", "use_regex"}):
        return (lambda ids: ids), 0
    kind = spec.get("type")
    if kind == "RobertaProcessing" and set(spec) <= {
            "type", "sep", "cls", "trim_offsets", "add_prefix_space"}:
        cls, sep = int(spec["cls"][1]), int(spec["sep"][1])
        return (lambda ids: [cls] + ids + [sep]), 2
    if kind == "TemplateProcessing" and set(spec) == {
            "type", "single", "pair", "special_tokens"}:
        before, after, seen = [], [], False
        for piece in spec["single"]:
            if "Sequence" in piece:
                if piece["Sequence"]["id"] != "A" or seen:
                    raise _unknown("post-processor", spec)
                seen = True
            elif "SpecialToken" in piece:
                ids = spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(int(i) for i in ids)
            else:
                raise _unknown("post-processor", spec)
        return (lambda ids: before + ids + after), len(before) + len(after)
    raise _unknown("post-processor", spec)


def _decoder(spec):
    """tokens -> str for a decoder entry (None: joined by spaces)."""
    if spec is None:
        return " ".join
    if spec.get("type") == "ByteLevel" and set(spec) <= {
            "type", "add_prefix_space", "trim_offsets", "use_regex"}:
        back = {c: b for b, c in bytes_to_unicode().items()}

        def byte_level(tokens):
            out = bytearray()
            for t in tokens:
                if all(c in back for c in t):
                    out.extend(back[c] for c in t)
                else:  # a token not of mapped characters passes as UTF-8
                    out.extend(t.encode("utf-8"))
            return out.decode("utf-8", errors="replace")
        return byte_level
    raise _unknown("decoder", spec)


# the tokenizer classes transformers maps the released configs (and HF's
# generic fast tokenizer) to; CLIP's wraps its decoder
_TOKENIZER_CLASSES = ("Qwen2Tokenizer", "CLIPTokenizer",
                      "PreTrainedTokenizerFast")
_SPECIALS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
             "cls_token", "mask_token")


def _content(v):
    return v.get("content") if isinstance(v, dict) else v


def _read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Tokenizer:
    """One HF tokenizer directory (see the module's docstring)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 chat_template: Optional[str] = None):
        config = config or {}
        cls = config.get("tokenizer_class")
        if cls is not None and cls not in _TOKENIZER_CLASSES \
                and cls[:-4] not in _TOKENIZER_CLASSES:
            raise ValueError(f"tokenizer: the class {cls!r} is not implemented "
                             "here")
        self.clip_decode = cls in ("CLIPTokenizer", "CLIPTokenizerFast")
        for key, want in (("split_special_tokens", False),
                          ("clean_up_tokenization_spaces", False),
                          ("padding_side", "right"), ("truncation_side", "right")):
            if config.get(key, want) != want:
                raise ValueError(f"tokenizer: {key} {config[key]!r} is not "
                                 "implemented here")
        self.model = _model(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.post, self.n_special = _post_processor(spec.get("post_processor"))
        # added tokens: content -> (id, special, normalized)
        self.added: Dict[str, tuple] = {}
        for tok in spec.get("added_tokens") or []:
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    raise ValueError(f"tokenizer: the added token "
                                     f"{tok['content']!r} sets {flag}, which is "
                                     "not implemented here")
            self.added[tok["content"]] = (int(tok["id"]), bool(tok["special"]),
                                          bool(tok["normalized"]))
        self.special_tokens = {k: _content(config[k]) for k in _SPECIALS
                               if _content(config.get(k)) is not None}
        self.additional_special_tokens = [
            _content(t) for t in config.get("additional_special_tokens") or []]
        for content in list(self.special_tokens.values()) + \
                self.additional_special_tokens:
            if content not in self.added:
                raise ValueError(f"tokenizer: the special token {content!r} is "
                                 "not an added token of tokenizer.json")
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({t[0]: c for c, t in self.added.items()})
        self.special_ids = {t[0] for t in self.added.values() if t[1]}

        def alternation(toks):  # leftmost-longest, as the HF matcher
            toks = sorted(toks, key=lambda t: (-len(t), t))
            return re.compile("|".join(map(re.escape, toks))) if toks else None
        self._raw_re = alternation([c for c, t in self.added.items() if not t[2]])
        self._norm_re = alternation([c for c, t in self.added.items() if t[2]])
        self.chat_template = chat_template
        pad = self.special_tokens.get("pad_token")
        self.pad_token_id = None if pad is None else self.added[pad][0]

    @classmethod
    def from_pretrained(cls, path) -> "Tokenizer":
        """The tokenizer of an HF checkpoint directory (``tokenizer.json``
        required; ``special_tokens_map.json`` over
        ``tokenizer_config.json``, as transformers reads them; the chat
        template from ``chat_template.jinja``, else the config, else
        ``chat_template.json``)."""
        path = str(path)
        file = os.path.join(path, "tokenizer.json")
        if not os.path.exists(file):
            raise FileNotFoundError(f"{file}: the tokenizer reads only "
                                    "tokenizer.json (no slow vocab/merges "
                                    "layout)")
        config = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            if os.path.exists(os.path.join(path, name)):
                config.update({k: v for k, v in
                               _read_json(os.path.join(path, name)).items()
                               if name == "tokenizer_config.json" or v is not None})
        template = config.get("chat_template")
        if isinstance(template, list):
            template = {t["name"]: t["template"] for t in template}.get("default")
        jinja = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja):
            with open(jinja, encoding="utf-8") as f:
                template = f.read()
        elif template is None and os.path.exists(
                os.path.join(path, "chat_template.json")):
            template = _read_json(os.path.join(path, "chat_template.json")).get(
                "chat_template")
        return cls(_read_json(file), config, template)

    # -- encoding -----------------------------------------------------

    def _pieces(self, regex, text):
        """(piece, added token id or None) over ``text`` split on ``regex``."""
        if regex is None:
            if text:
                yield text, None
            return
        prev = 0
        for m in regex.finditer(text):
            if m.start() > prev:
                yield text[prev:m.start()], None
            yield m.group(), self.added[m.group()][0]
            prev = m.end()
        if prev < len(text):
            yield text[prev:], None

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """The ids of one text: added tokens split out first (those not
        normalized before the normalizer runs), then the pipeline, then the
        post-processor's special tokens when ``add_special_tokens``."""
        ids: List[int] = []
        for raw, tok in self._pieces(self._raw_re, text):
            if tok is not None:
                ids.append(tok)
                continue
            norm = self.normalize(raw) if self.normalize else raw
            for piece, tok2 in self._pieces(self._norm_re, norm):
                if tok2 is not None:
                    ids.append(tok2)
                    continue
                for word in self.pre_tokenize(piece):
                    if word:
                        ids.extend(self.model(word))
        return self.post(ids) if add_special_tokens else ids

    def __call__(self, text, max_length: Optional[int] = None,
                 truncation: bool = False, padding=False,
                 add_special_tokens: bool = True, return_tensors: str = "np"):
        """``input_ids`` and ``attention_mask`` of a text or a list of
        texts as (rows, length) int64 arrays, as a fast HF tokenizer gives
        them with ``return_tensors="np"``: ``truncation`` keeps
        ``max_length`` tokens, the special ones included; ``padding=
        "max_length"`` pads each row to ``max_length`` on the right."""
        if return_tensors != "np" or padding not in (False, "max_length") or \
                ((truncation or padding) and max_length is None):
            raise ValueError(f"tokenizer: return_tensors {return_tensors!r}, "
                             f"padding {padding!r} with max_length "
                             f"{max_length!r} is not implemented here")
        rows = []
        for t in text if isinstance(text, (list, tuple)) else [text]:
            ids = self.encode(t, add_special_tokens=False)
            if truncation:
                keep = max_length - (self.n_special if add_special_tokens else 0)
                ids = ids[:max(keep, 0)]
            rows.append(self.post(ids) if add_special_tokens else ids)
        masks = [[1] * len(r) for r in rows]
        if padding:
            if self.pad_token_id is None:
                raise ValueError("tokenizer: asked to pad, but there is no "
                                 "pad_token")
            for r, m in zip(rows, masks):
                n = max(0, max_length - len(r))
                r.extend([self.pad_token_id] * n)
                m.extend([0] * n)
        if len({len(r) for r in rows}) > 1:
            raise ValueError("tokenizer: rows of different lengths make no "
                             "array; pad them")
        shape = (len(rows), -1)
        return {"input_ids": np.asarray(rows, dtype=np.int64).reshape(shape),
                "attention_mask": np.asarray(masks, dtype=np.int64).reshape(shape)}

    # -- chat template and decoding -----------------------------------

    def apply_chat_template(self, conversation, tokenize: bool = False,
                            add_generation_prompt: bool = False, **kwargs) -> str:
        """The chat template rendered as transformers renders it (jinja2's
        sandbox, trim_blocks and lstrip_blocks, its ``tojson``,
        ``raise_exception`` and ``strftime_now``, the special tokens as
        variables); text only (``tokenize=False``)."""
        import datetime

        import jinja2
        import jinja2.ext
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        if tokenize:
            raise ValueError("tokenizer: apply_chat_template renders text "
                             "only (tokenize=False)")
        if self.chat_template is None:
            raise ValueError("tokenizer: the directory holds no chat template")

        def raise_exception(message):
            raise jinja2.exceptions.TemplateError(message)

        def tojson(x, ensure_ascii=False, indent=None, separators=None,
                   sort_keys=False):
            return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                              separators=separators, sort_keys=sort_keys)

        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True,
            extensions=[jinja2.ext.loopcontrols])
        env.filters["tojson"] = tojson
        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = \
            lambda fmt: datetime.datetime.now().strftime(fmt)
        variables = dict(self.special_tokens)
        if self.additional_special_tokens:
            variables["additional_special_tokens"] = self.additional_special_tokens
        variables.update(kwargs)
        return env.from_string(self.chat_template).render(
            messages=conversation, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt, **variables)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """The text of ``ids`` (ids unknown to the tokenizer are dropped, as
        ``tokenizers`` drops them)."""
        tokens = [self.id_to_token[i] for i in map(int, ids)
                  if i in self.id_to_token
                  and not (skip_special_tokens and i in self.special_ids)]
        text = self.decoder(tokens)
        suffix = getattr(self.model, "suffix", "")
        if self.clip_decode and suffix:  # CLIPTokenizerFast's wrap
            text = text.replace(suffix, " ").strip()
        return text
