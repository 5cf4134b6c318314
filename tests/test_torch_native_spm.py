"""The port's native SentencePiece-BPE encoder (dynamo_tpu_torch/native/
spm_bpe.cpp, spm.py): id for id with the port's Python encoder
(llm/gguf._spm_encode) and with the JAX package's, on the seeded fuzz
corpus of tests/test_native_spm.py (random vocabs with tied scores, a
duplicated token, multi-byte UTF-8 and characters absent from the vocab),
and used by GGUFTokenizer. A failed build is counted and logged.
"""
import random

import pytest

from dynamo_tpu.llm import gguf as jg
from dynamo_tpu_torch import native
from dynamo_tpu_torch.llm import gguf as tg
from dynamo_tpu_torch.native.spm import available, make_encoder
from test_gguf import make_tiny_gguf
from test_native_spm import SPACE, build_vocab, random_text


def test_native_builds():
    assert available(), native.NATIVE_STATS.last_error
    assert native.library_path("spm_bpe").exists()


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_native_matches_python_and_jax_fuzz(seed):
    rng = random.Random(seed)
    for trial in range(30):
        toks, scores, byte_ids, ids = build_vocab(rng)
        enc = make_encoder(toks, scores, byte_ids, 0)
        assert enc is not None
        for _ in range(20):
            text = random_text(rng, rng.randint(0, 40))
            for add_prefix in (True, False):
                want = jg._spm_encode(text, ids, scores, byte_ids, 0, SPACE,
                                      add_prefix)
                py = tg._spm_encode(text, ids, scores, byte_ids, 0, SPACE,
                                    add_prefix)
                got = enc.encode(tg._spm_prepare(text, SPACE, add_prefix))
                assert got == py == want, (trial, text, add_prefix)


def test_native_empty_and_unk():
    enc = make_encoder(["<unk>", "a", "b", "ab"], [0.0, 0.0, 0.0, 5.0], {}, 0)
    assert enc.encode("") == []
    assert enc.encode("ab") == [3]
    assert enc.encode("zz") == [0, 0]   # no byte tokens, absent: unk


def test_gguf_tokenizer_uses_native(tmp_path):
    """GGUFTokenizer takes the native encoder and gives the ids of the
    Python path and of the JAX tokenizer on the tiny SPM vocab."""
    path = str(tmp_path / "m.gguf")
    make_tiny_gguf(path)
    tok = tg.GGUFTokenizer(tg.GGUFFile(path))
    jtok = jg.GGUFTokenizer(jg.GGUFFile(path))
    assert tok._native is not None
    rng = random.Random(5)
    words = ["hello", "world", "the", "é", "中", " ", "zz", "!"]
    for text in ["hello world the", ""] + [
            "".join(rng.choice(words) for _ in range(rng.randint(1, 12)))
            for _ in range(50)]:
        ids = tok.encode(text)
        assert ids == tg._spm_encode(text, tok._ids, tok._scores,
                                     tok._byte_ids, tok.unk_token_id,
                                     tok.SPACE, tok._add_prefix)
        assert ids == jtok.encode(text)
    assert tok.decode(tok.encode("hello world the")) == "hello world the"


def test_build_failure_is_counted_and_falls_back(tmp_path, monkeypatch,
                                                 caplog):
    """No toolchain: the build failure is counted and logged, and the
    tokenizer encodes in Python with the same ids."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setenv("PATH", str(tmp_path / "nobin"))
    before = native.NATIVE_STATS.build_failures
    path = str(tmp_path / "m.gguf")
    make_tiny_gguf(path)
    with caplog.at_level("WARNING", logger="dynamo_tpu_torch.native"):
        tok = tg.GGUFTokenizer(tg.GGUFFile(path))
    assert tok._native is None
    assert native.NATIVE_STATS.build_failures == before + 1
    assert "spm_bpe" in native.NATIVE_STATS.last_error
    assert any("native build of spm_bpe failed" in r.getMessage()
               for r in caplog.records)
    jtok = jg.GGUFTokenizer(jg.GGUFFile(path))
    assert tok.encode("hello world the") == jtok.encode("hello world the")
