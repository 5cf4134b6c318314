"""The port's tokenizer (dynamo_tpu_torch/llm/bpe.py behind
llm/tokenizer.HFTokenizer) against the JAX package's HFTokenizer (the HF
`tokenizers` package) on the same tokenizer.json files.

The files are built here with `tokenizers`, in the published forms of the
families models/loader.py admits: Llama-3 (the llama3 split pattern,
ByteLevel, ignore_merges), Qwen2 (NFC, its pattern), GPT-2 (ByteLevel's own
regex), Llama-2 / Mistral (Prepend + Replace normalizers with the
Replace / ByteFallback / Fuse / Strip decoder, and the Metaspace form) and
Gemma (Replace normalizer, byte fallback), each with added special tokens.
Encode ids, decode strings and DecodeStream deltas must be identical on a
fixed corpus and on hypothesis text; the translated Oniguruma patterns
must split like the `regex` package; unsupported components are refused
by name.
"""
import json
import sys
import unicodedata

import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (
    Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
    trainers,
)

from dynamo_tpu.llm.tokenizer import DecodeStream as JDecodeStream
from dynamo_tpu.llm.tokenizer import HFTokenizer as JHFTokenizer
from dynamo_tpu_torch.llm import bpe
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "Hello world! It's a test, isn't it? We'll see: they're HERE, I'M "
    "sure, you'VE done it, she'D go, we'LL try.",
    "Numbers 1234567 and 3.14159, 2024-10-17, 007 and 1,000,000.",
    "CJK 東京は日本の首都です。中文测试，한국어 텍스트입니다.",
    "Emoji 😀🎉👍🏽 and 👨‍👩‍👧 families; café naïve façade Ångström.",
    "Windows\r\nline\r\nendings\n\nand   runs    of\t\tspaces  \n  end ",
    "code: def f(x):\n    return x ** 2  # square\n\tindent",
    "<|begin_of_text|>system<|eot_id|> mixed <s> specials </s>inside",
    "punctuation!!! ... ??? --- ((( ))) [[ ]] {{ }} @#$%^&*",
    "Ünïcödé ṫëẍṫ ΑΒΓ δεζ Кириллица עברית العربية हिन्दी",
    "  leading spaces and trailing   ",
]
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
            "<|start_header_id|>", "<|end_header_id|>"]
SPM_SPECIALS = ["<unk>", "<s>", "</s>"]


def _train_bpe(tok, vocab_size, alphabet=()):
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=list(alphabet))
    tok.train_from_iterator(CORPUS * 4, trainer)
    return json.loads(tok.to_str())


def _with_byte_tokens(spec, first_ids=SPM_SPECIALS):
    """An SPM-style vocab: specials first, <0x00>..<0xFF>, then the
    trained pieces, ids renumbered; merges kept."""
    old = spec["model"]["vocab"]
    order = list(first_ids) + [f"<0x{b:02X}>" for b in range(256)]
    order += [t for t, _ in sorted(old.items(), key=lambda kv: kv[1])
              if t not in order]
    spec["model"]["vocab"] = {t: i for i, t in enumerate(order)}
    return spec


def _add_specials(spec, contents, flags=None):
    vocab = spec["model"]["vocab"]
    nxt = max(vocab.values()) + 1
    out = []
    for c in contents:
        tid = vocab.get(c)
        if tid is None:
            tid, nxt = nxt, nxt + 1
        out.append({"id": tid, "content": c, "single_word": False,
                    "lstrip": False, "rstrip": False, "normalized": False,
                    "special": True, **(flags or {}).get(c, {})})
    spec["added_tokens"] = out
    return spec


def byte_level_form(pattern, ignore_merges, nfc=False, gpt2=False):
    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    if gpt2:
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    else:
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(pattern), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
    if nfc:
        tok.normalizer = normalizers.NFC()
    tok.decoder = decoders.ByteLevel()
    spec = _train_bpe(tok, 600, pre_tokenizers.ByteLevel.alphabet())
    return _add_specials(spec, SPECIALS)


def spm_form(kind):
    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>",
                               fuse_unk=True))
    if kind == "llama2":
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
        tok.decoder = decoders.Sequence([
            decoders.Replace("▁", " "), decoders.ByteFallback(),
            decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    elif kind == "metaspace":
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
        tok.decoder = decoders.Metaspace(replacement="▁",
                                         prepend_scheme="first", split=False)
    else:   # gemma
        tok.normalizer = normalizers.Replace(" ", "▁")
        tok.decoder = decoders.Sequence([
            decoders.Replace("▁", " "), decoders.ByteFallback(),
            decoders.Fuse()])
    spec = _with_byte_tokens(_train_bpe(tok, 500))
    specials = SPM_SPECIALS + (["<start_of_turn>", "<end_of_turn>"]
                               if kind == "gemma" else [])
    return _add_specials(spec, specials)


FORMS = {
    "llama3": lambda: byte_level_form(LLAMA3_PATTERN, True),
    "qwen2": lambda: byte_level_form(QWEN2_PATTERN, False, nfc=True),
    "gpt2": lambda: byte_level_form(None, False, gpt2=True),
    "llama2": lambda: spm_form("llama2"),
    "mistral_metaspace": lambda: spm_form("metaspace"),
    "gemma": lambda: spm_form("gemma"),
}


@pytest.fixture(scope="module", params=sorted(FORMS))
def pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param) / "tokenizer.json"
    path.write_text(json.dumps(FORMS[request.param]()))
    return (request.param, JHFTokenizer(str(path), [2], 1),
            HFTokenizer(str(path), [2], 1))


def _same(pair, text):
    _, j, t = pair
    ids = j.encode(text)
    assert t.encode(text) == ids, text
    assert t.decode(ids) == j.decode(ids)
    return ids


def test_corpus(pair):
    _, j, t = pair
    assert t.vocab_size == j.vocab_size
    assert (t.eos_token_ids, t.bos_token_id) == (j.eos_token_ids,
                                                 j.bos_token_id)
    for text in CORPUS + ["", " ", "\n", "a", "<s>", "<|eot_id|><|eot_id|>",
                          "'S'T're", "x" * 300]:
        _same(pair, text)


def test_decode_stream_deltas(pair):
    _, j, t = pair
    text = " ".join(CORPUS)
    ids = j.encode(text)
    js, ts = JDecodeStream(j), DecodeStream(t)
    for i in ids:
        assert ts.step(i) == js.step(i)


def test_decode_odd_ids(pair):
    """Ids outside the vocabulary and lone bytes decode as `tokenizers`
    decodes them."""
    _, j, t = pair
    n = j.vocab_size
    for ids in ([n + 5], [0, n + 1, 1, 2], list(range(3, 40)),
                list(range(n - 20, n + 3)), [7, 8, 9, 10]):
        assert t.decode(ids) == j.decode(ids), ids


def _newer_code_points() -> str:
    """Code points Python's unicodedata (Unicode 15.0 in Python 3.12)
    leaves unassigned but the `regex` package's newer tables assign: the
    Unicode-version difference of ROADMAP §C, the only ones left out."""
    return "".join(
        chr(cp) for cp in range(sys.maxunicode + 1)
        if unicodedata.category(chr(cp)) == "Cn"
        and regex.match(r"\p{Assigned}", chr(cp)))


# combining marks of Unicode 11-15 whose canonical combining class the
# `tokenizers` NFC tables (older than Python 3.12's Unicode 15.0) do not
# have, so its NFC leaves them unordered (ROADMAP §C): left out of the
# texts held against `tokenizers`
NFC_TABLE_DIFF = "".join(chr(c) for c in (
    0x7FD, *range(0x898, 0x8A0), *range(0x8CA, 0x8D4), 0x9FE, 0xC3C,
    0xD3B, 0xD3C, 0xEBA, 0x1715, *range(0x1ABF, 0x1ACF),
    *range(0x1DF6, 0x1DFB), 0xA82C, *range(0x10D24, 0x10D28), 0x10EAB,
    0x10EAC, *range(0x10EFD, 0x10F00), *range(0x10F46, 0x10F51),
    *range(0x10F82, 0x10F86), 0x11070, 0x1133B, 0x1145E, 0x11839, 0x1183A,
    0x1193D, 0x1193E, 0x11943, 0x119E0, 0x11A34, 0x11A47, 0x11A99, 0x11D42,
    0x11D44, 0x11D45, 0x11D97, 0x11F41, 0x11F42, 0x16FF0, 0x16FF1, 0x1E08F,
    *range(0x1E130, 0x1E137), 0x1E2AE, *range(0x1E2EC, 0x1E2F0),
    *range(0x1E4EC, 0x1E4F0)))
NEWER = _newer_code_points()


def _texts(excluded: str):
    text = st.text(alphabet=st.characters(
        blacklist_categories=("Cs",), blacklist_characters=excluded),
        max_size=60)
    return st.lists(st.one_of(text, st.sampled_from(
        SPECIALS + SPM_SPECIALS + [" ", "\r\n", "  \t", "'s", "'LL",
                                   "123456"])), max_size=6).map("".join)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_texts(NEWER + NFC_TABLE_DIFF))
def test_hypothesis_text(pair, text):
    _same(pair, text)


@settings(max_examples=200, deadline=None)
@given(text=_texts(NEWER))
@pytest.mark.parametrize("pattern", [LLAMA3_PATTERN, QWEN2_PATTERN,
                                     bpe.GPT2_PATTERN])
def test_translated_pattern_splits_like_regex(pattern, text):
    want = [m.span() for m in regex.finditer(pattern, text)]
    got = [m.span() for m in bpe.compile_onig(pattern).finditer(text)]
    assert got == want


def test_onig_whitespace_class():
    """Oniguruma's \\s: U+0009-000D, U+0085 and the Z separators; not
    U+001C-001F (which Python's \\s takes)."""
    rx = bpe.compile_onig(r"\s")
    for ch in "\t\n\x0b\x0c\r \x85\xa0  　":
        assert rx.fullmatch(ch), hex(ord(ch))
    for ch in "\x1c\x1d\x1e\x1fa​":
        assert not rx.fullmatch(ch), hex(ord(ch))


@pytest.mark.parametrize("section,spec,name", [
    ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece"),
    ("model", {"type": "Unigram", "vocab": []}, "Unigram"),
    ("pre_tokenizer", {"type": "BertPreTokenizer"}, "BertPreTokenizer"),
    ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
    ("normalizer", {"type": "Lowercase"}, "Lowercase"),
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("decoder", {"type": "WordPiece", "prefix": "##"}, "WordPiece"),
])
def test_unsupported_components_refused(section, spec, name):
    base = FORMS["gpt2"]()
    base[section] = spec
    with pytest.raises(ValueError, match=name):
        bpe.BPETokenizer(base)


@pytest.mark.parametrize("edit,name", [
    (lambda t: t["model"].update(continuing_subword_prefix="##"),
     "continuing_subword_prefix"),
    (lambda t: t["model"].update(dropout=0.1), "dropout"),
    (lambda t: t["added_tokens"][0].update(single_word=True), "single_word"),
    (lambda t: t.update(normalizer={"type": "Replace", "pattern": {
        "Regex": " +"}, "content": "_"}), "regex pattern in Replace"),
    (lambda t: t.update(pre_tokenizer={"type": "Split", "pattern": {
        "Regex": r"\d+"}, "behavior": "Isolated", "invert": False}),
     r"regex class \\d"),
])
def test_unsupported_settings_refused(edit, name):
    """Settings no admitted family uses are refused by name, never
    approximated (the regex ones when first used)."""
    base = FORMS["gpt2"]()
    edit(base)
    with pytest.raises(ValueError, match=name):
        bpe.BPETokenizer(base).encode("x 12")
