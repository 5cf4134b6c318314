"""A BPE tokenizer over HF `tokenizer.json` files, in plain Python.

The port's own stand-in for the HF `tokenizers` package, which it cannot
import (the port depends on torch and numpy only). It reproduces what the
JAX package's `HFTokenizer` (dynamo_tpu/llm/tokenizer.py, a wrapper of
`tokenizers.Tokenizer`) computes for the files of the model families
models/loader.py admits (Llama-3, Llama-2, Mistral, Mixtral, Qwen2, Gemma,
Phi-3): `encode(text, add_special_tokens=False)` and `decode(ids,
skip_special_tokens=False)`. Any other component raises ValueError naming
it; nothing is approximated.

- model: BPE (vocab, merges as "a b" strings or [a, b] pairs, ranks by
  position, `ignore_merges`, `byte_fallback`, `unk_token` / `fuse_unk`);
- added tokens split out first, leftmost-longest, with their `special`,
  `lstrip`, `rstrip` and `normalized` flags (normalized ones matched on
  the normalized text, as `tokenizers` does);
- normalizers: NFC, Prepend, Replace, Sequence;
- pre-tokenizers: Split (a string or a regex, each `behavior`, `invert`),
  ByteLevel (`add_prefix_space`, `use_regex`), Metaspace
  (`prepend_scheme`, `split`), Sequence;
- decoders: ByteLevel, ByteFallback, Fuse, Strip, Replace, Metaspace,
  Sequence.

Regexes are those of the Oniguruma engine `tokenizers` uses: `\\p{L}`,
`\\p{N}` (any general category) and `\\s` / `\\S` are translated
once, at first use, into explicit character classes built from
`unicodedata` (Oniguruma's `\\s` is U+0009-000D, U+0085 and the Z
separators, which Python's `\\s` is not), so that Python `re` runs the
pattern with its alternation order and backtracking unchanged.
"""
from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# -- regex translation --------------------------------------------------------

_ONIG_SPACE = ("\t", "\n", "\x0b", "\x0c", "\r", "\x85")


def _ranges(chars) -> str:
    """A character-class body for a sorted iterable of code points."""
    out, run = [], None
    for cp in chars:
        if run and cp == run[1] + 1:
            run[1] = cp
            continue
        if run:
            out.append(run)
        run = [cp, cp]
    if run:
        out.append(run)

    def esc(cp):
        return f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in out)


@functools.lru_cache(maxsize=None)
def _category_class(prefix: str) -> str:
    """Class body of every code point whose general category starts with
    `prefix` ("L", "N", "Lu", ...)."""
    return _ranges(cp for cp in range(sys.maxunicode + 1)
                   if unicodedata.category(chr(cp)).startswith(prefix))


@functools.lru_cache(maxsize=None)
def _space_class() -> str:
    """Oniguruma's \\s: U+0009-000D, U+0085, Zl, Zp, Zs."""
    return _ranges(sorted({ord(c) for c in _ONIG_SPACE} | {
        cp for cp in range(sys.maxunicode + 1)
        if unicodedata.category(chr(cp)) in ("Zl", "Zp", "Zs")}))


_GENERAL_CATEGORIES = {"L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "Mn", "Mc",
                       "Me", "N", "Nd", "Nl", "No", "P", "Pc", "Pd", "Ps",
                       "Pe", "Pi", "Pf", "Po", "S", "Sm", "Sc", "Sk", "So",
                       "Z", "Zs", "Zl", "Zp", "C", "Cc", "Cf", "Co", "Cn"}


@functools.lru_cache(maxsize=None)
def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern -> the same pattern for Python `re`, with the
    Unicode classes spelled out (inside and outside brackets)."""
    out, i, depth = [], 0, 0   # depth: inside a [...] class
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i)
                name = pattern[i + 3:end]
                neg = nxt == "P"
                if name.startswith("^"):
                    name, neg = name[1:], not neg
                if name not in _GENERAL_CATEGORIES:
                    raise ValueError(f"unsupported regex property "
                                     f"\\{nxt}{{{name}}} in {pattern!r}")
                body = _category_class(name)
                i = end + 1
            elif nxt in "sS":
                body, neg = _space_class(), nxt == "S"
                i += 2
            elif nxt in "dDwWhH":
                raise ValueError(f"unsupported regex class \\{nxt} in "
                                 f"{pattern!r}")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if depth:
                if neg:
                    raise ValueError(f"negated class inside brackets in "
                                     f"{pattern!r}")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[" and not depth:
            depth = 1
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":   # a literal ] first
                out.append("\\]")
                i += 1
            continue
        if c == "[" and depth:
            raise ValueError(f"nested character class in {pattern!r}")
        if c == "]" and depth:
            depth = 0
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_onig(pattern: str) -> "re.Pattern":
    return re.compile(translate_regex(pattern))


# the builtin pre-tokenization regex of ByteLevel(use_regex=True) (GPT-2)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@functools.lru_cache(maxsize=None)
def _white_space() -> frozenset:
    """Rust's char::is_whitespace (the Unicode White_Space property)."""
    return frozenset(chr(c) for c in (
        *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
        0x2028, 0x2029, 0x202F, 0x205F, 0x3000))


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
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


BYTES_CHAR = bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTES_CHAR.items()}


# -- pieces -------------------------------------------------------------------

class _Piece:
    """A stretch of text on its way to the model: `first` when it starts
    at offset 0 of the original input (Metaspace's prepend_scheme "first"),
    `token` once it is an added token's id."""

    __slots__ = ("text", "first", "token")

    def __init__(self, text: str, first: bool, token: Optional[int] = None):
        self.text, self.first, self.token = text, first, token


def _pattern_of(spec: dict) -> Tuple[str, bool]:
    """(pattern, is_regex) of a tokenizer.json pattern object."""
    if "Regex" in spec:
        return spec["Regex"], True
    if "String" in spec:
        return spec["String"], False
    raise ValueError(f"unsupported pattern {spec!r}")


def _literal_of(spec: dict, where: str) -> str:
    """A string pattern (the families' Replace components use no regex)."""
    pat, is_regex = _pattern_of(spec)
    if is_regex:
        raise ValueError(f"unsupported regex pattern in {where}: {pat!r}")
    return pat


def _find(pattern: str, is_regex: bool, text: str) -> List[Tuple[int, int]]:
    if is_regex:
        return [m.span() for m in compile_onig(pattern).finditer(text)]
    if not pattern:
        return []
    out, start = [], 0
    while True:
        at = text.find(pattern, start)
        if at < 0:
            return out
        out.append((at, at + len(pattern)))
        start = at + len(pattern)


def split_text(text: str, spans, behavior: str, invert: bool = False
               ) -> List[Tuple[int, int]]:
    """`tokenizers`' NormalizedString.split: the matches and the stretches
    between them, merged or removed as `behavior` says; empty ones drop."""
    marks: List[Tuple[Tuple[int, int], bool]] = []
    if not text:
        marks = [((0, 0), False)]
    prev = 0
    for a, b in spans:
        if prev != a:
            marks.append(((prev, a), False))
        marks.append(((a, b), True))
        prev = b
    if text and prev != len(text):
        marks.append(((prev, len(text)), False))
    if invert:
        marks = [(o, not m) for o, m in marks]
    behavior = behavior.lower()
    out: List[list] = []
    if behavior == "isolated":
        out = [[a, b, False] for (a, b), _ in marks]
    elif behavior == "removed":
        out = [[a, b, m] for (a, b), m in marks]
    elif behavior in ("mergedwithprevious", "contiguous"):
        prev_match = False
        for (a, b), m in marks:
            join = (m and not prev_match) if behavior == \
                "mergedwithprevious" else m == prev_match
            if join and out:
                out[-1][1] = b
            else:
                out.append([a, b, False])
            prev_match = m
    elif behavior == "mergedwithnext":
        prev_match = False
        for (a, b), m in reversed(marks):
            if m and not prev_match and out:
                out[-1][0] = a
            else:
                out.append([a, b, False])
            prev_match = m
        out.reverse()
    else:
        raise ValueError(f"unsupported split behavior {behavior!r}")
    return [(a, b) for a, b, removed in out if not removed and b > a]


# -- normalizers --------------------------------------------------------------

def _normalizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def seq(text):
            for p in parts:
                text = p(text)
            return text
        return seq
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda text: pre + text if text else text
    if kind == "Replace":
        pat, content = _literal_of(spec["pattern"], "Replace"), spec["content"]
        return lambda text: text.replace(pat, content) if pat else text
    raise ValueError(f"unsupported normalizer {kind!r} (supported: NFC, "
                     f"Prepend, Replace, Sequence)")


# -- pre-tokenizers -----------------------------------------------------------

def _pre_tokenizer(spec: Optional[dict]):
    """spec -> fn(list of _Piece) -> list of _Piece (token pieces pass
    through untouched)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "Split":
        pat, is_regex = _pattern_of(spec["pattern"])
        behavior, invert = spec["behavior"], bool(spec.get("invert", False))

        def split(text, first):
            return [(text[a:b], first and a == 0) for a, b in split_text(
                text, _find(pat, is_regex, text), behavior, invert)]
        return _each(split)
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", True))
        use_regex = bool(spec.get("use_regex", True))

        def byte_level(text, first):
            if prefix and not text.startswith(" "):
                text = " " + text
            spans = ([(a, b) for a, b in split_text(
                text, _find(GPT2_PATTERN, True, text), "isolated")]
                if use_regex else [(0, len(text))])
            return [("".join(BYTES_CHAR[b] for b in text[a:b].encode()),
                     first and a == 0) for a, b in spans]
        return _each(byte_level)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:   # the older form: add_prefix_space
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        do_split = bool(spec.get("split", True))
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"unsupported Metaspace prepend_scheme "
                             f"{scheme!r}")

        def metaspace(text, first):
            text = text.replace(" ", rep)
            if (scheme == "always" or (scheme == "first" and first)) \
                    and not text.startswith(rep):
                text = rep + text
            if not do_split:
                return [(text, first)]
            return [(text[a:b], first and a == 0) for a, b in split_text(
                text, _find(rep, False, text), "mergedwithnext")]
        return _each(metaspace)
    raise ValueError(f"unsupported pre-tokenizer {kind!r} (supported: "
                     f"Split, ByteLevel, Metaspace, Sequence)")


def _each(fn):
    def run(pieces):
        out = []
        for p in pieces:
            if p.token is not None:
                out.append(p)
                continue
            out.extend(_Piece(t, f) for t, f in fn(p.text, p.first) if t)
        return out
    return run


# -- decoders -----------------------------------------------------------------

def _decoder(spec: Optional[dict]):
    """spec -> fn(list of token strings) -> list of strings (the decode
    chain; the result is joined with "")."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        def byte_level(tokens):
            raw = bytearray()
            for t in tokens:
                try:
                    raw.extend(CHAR_BYTES[c] for c in t)
                except KeyError:
                    raw.extend(t.encode())
            return [raw.decode("utf-8", "replace")]
        return byte_level
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b, k = len(t), 0
                while k < stop and b > a and t[b - 1] == content:
                    b, k = b - 1, k + 1
                out.append(t[a:b])
            return out
        return strip
    if kind == "Replace":
        pat, content = _literal_of(spec["pattern"], "Replace"), spec["content"]
        return lambda tokens: [t.replace(pat, content) if pat else t
                               for t in tokens]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"

        def metaspace(tokens):
            return ["".join(("" if i == 0 and scheme != "never" else " ")
                            if c == rep else c for c in t)
                    for i, t in enumerate(tokens)]
        return metaspace
    raise ValueError(f"unsupported decoder {kind!r} (supported: ByteLevel, "
                     f"ByteFallback, Fuse, Strip, Replace, Metaspace, "
                     f"Sequence)")


def _byte_fallback(tokens):
    out, pending = [], bytearray()

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()
    for t in tokens:
        b = None
        if len(t.encode()) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                b = int(t[3:5], 16)
            except ValueError:
                b = None
        if b is not None:
            pending.append(b)
            continue
        flush()
        out.append(t)
    flush()
    return out


# -- the model ----------------------------------------------------------------

class BPEModel:
    """`tokenizers.models.BPE` at inference (no dropout)."""

    def __init__(self, spec: dict):
        kind = spec.get("type", "BPE" if "merges" in spec else None)
        if kind != "BPE":
            raise ValueError(f"unsupported tokenizer model {kind!r} "
                             f"(supported: BPE)")
        if spec.get("dropout"):
            raise ValueError("BPE dropout is not supported")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise ValueError(f"unsupported BPE {key} {spec[key]!r}")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", ())):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"bad merge {m!r}")
                a, b = parts
            else:
                a, b = m
            new = a + b
            for tok in (a, b, new):
                if tok not in self.vocab:
                    raise ValueError(f"merge {a!r} {b!r}: {tok!r} is not "
                                     f"in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                           self.vocab[new])
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        got = self._cache.get(word)
        if got is not None:
            return got
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._merge(self._symbols(word))
        if len(self._cache) < 10000:
            self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> List[int]:
        syms: List[int] = []
        unk: Optional[int] = None   # a pending (fused) unknown
        for s in word:
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if all(t is not None for t in fb):
                    syms.extend(fb)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"unk token {self.unk_token!r} is not "
                                     f"in the vocabulary")
                uid = self.vocab[self.unk_token]
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = uid
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge(self, syms: List[int]) -> List[int]:
        n = len(syms)
        if n < 2:
            return syms
        c = list(syms)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] < 0:
                continue
            right = nxt[pos]
            m = self.merges.get((c[pos], c[right]))
            if m is None or m[1] != new:
                continue   # an expired entry
            c[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] >= 0:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((c[prv[pos]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] >= 0:
                m = self.merges.get((new, c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


# -- the tokenizer ------------------------------------------------------------

class BPETokenizer:
    """tokenizer.json -> encode / decode with the `tokenizers` semantics
    (add_special_tokens=False, skip_special_tokens=False)."""

    def __init__(self, spec: dict):
        self.model = BPEModel(spec["model"])
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added: Dict[str, dict] = {}
        for tok in spec.get("added_tokens") or ():
            if tok.get("single_word"):
                raise ValueError(f"unsupported single_word added token "
                                 f"{tok['content']!r}")
            self.added[tok["content"]] = tok
        self.added_ids = {t["id"]: c for c, t in self.added.items()}
        self.specials = {c for c, t in self.added.items() if t.get("special")}
        raw = [c for c, t in self.added.items() if not t.get("normalized")]
        normed = [c for c, t in self.added.items() if t.get("normalized")]
        self._raw_rx = self._alternation(raw)
        # normalized added tokens match the normalized text, so their
        # contents are normalized too
        self._norm_map = {(self.normalizer(c) if self.normalizer else c): c
                          for c in normed}
        self._norm_rx = self._alternation(list(self._norm_map))

    @classmethod
    def from_file(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @staticmethod
    def _alternation(contents):
        """Leftmost-longest over literal strings: at the leftmost match
        position the longest content wins (aho-corasick LeftmostLongest)."""
        contents = [c for c in contents if c]
        if not contents:
            return None
        return re.compile("|".join(re.escape(c) for c in sorted(
            contents, key=lambda c: (-len(c), c))))

    def vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]["id"]
        return self.model.vocab.get(token)

    # encode ---------------------------------------------------------------

    def _split_added(self, pieces: List[_Piece], rx, contents) -> list:
        if rx is None:
            return pieces
        out: List[_Piece] = []
        ws = _white_space()
        for p in pieces:
            if p.token is not None:
                out.append(p)
                continue
            text, start_offset = p.text, 0
            for m in rx.finditer(text):
                start, stop = m.span()
                tok = self.added[contents.get(m.group(), m.group())]
                if tok.get("lstrip"):
                    s = start
                    while s > 0 and text[s - 1] in ws:
                        s -= 1
                    start = max(s, start_offset)
                if tok.get("rstrip"):
                    while stop < len(text) and text[stop] in ws:
                        stop += 1
                if start_offset < start:
                    out.append(_Piece(text[start_offset:start],
                                      p.first and start_offset == 0))
                out.append(_Piece(text[start:stop], False, tok["id"]))
                start_offset = stop
            if start_offset != len(text) or not text:
                out.append(_Piece(text[start_offset:],
                                  p.first and start_offset == 0))
        return out

    def encode(self, text: str) -> List[int]:
        pieces = self._split_added([_Piece(text, True)], self._raw_rx, {})
        if self.normalizer is not None:
            for p in pieces:
                if p.token is None:
                    p.text = self.normalizer(p.text)
        pieces = self._split_added(pieces, self._norm_rx, self._norm_map)
        pieces = [p for p in pieces if p.token is not None or p.text]
        if self.pre_tokenizer is not None:
            pieces = self.pre_tokenizer(pieces)
        ids: List[int] = []
        for p in pieces:
            if p.token is not None:
                ids.append(p.token)
            else:
                ids.extend(self.model.tokenize(p.text))
        return ids

    # decode ---------------------------------------------------------------

    def decode(self, ids: Sequence[int]) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            tok = self.added_ids.get(i)
            if tok is None:
                tok = self.model.id_to_token.get(i)
            if tok is not None:
                tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))

