"""The port's multimodal path (dynamo_tpu_torch/models/vision.py, the
engine's vision prefill, the scheduler's content salts and span slicing,
the preprocessor's image parts, the worker and disaggregated transfer of
images, the HTTP frontend) against the JAX package's, case for case with
tests/test_vision.py.

The JAX side runs as tests/test_vision.py runs it; the port runs on the
CPU on the JAX engine's weights (`params_from_jax`, the vision tower
included), in float32: encoder outputs within 1e-5 (bf16 within 2^-5 and
1% in relative norm), token streams identical. The content salts are BLAKE2b where JAX's are
xxh3, so the cases compare the salts' structure and the prefix-cache hits,
never the salt values. Left out: the pp case (multi-device, A10).
"""
import asyncio
import base64
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    VisionConfig as JVisionConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
    VisionConfig as TVisionConfig,
)
from dynamo_tpu_torch.engine.engine import NativeEngine as TNativeEngine
from dynamo_tpu_torch.engine.scheduler import (
    EngineRequest as TRequest, SamplingParams as TSamplingParams,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import vision as tvision
from dynamo_tpu_torch.models.llama import params_from_jax

from tests.http_client import request, sse_events

torch.set_num_threads(1)

VISION = dict(image_size=28, patch_size=14, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=2)
JCFG = JModelConfig(dtype="float32", max_model_len=256,
                    vision=JVisionConfig(**VISION))
TCFG = TModelConfig(dtype="float32", max_model_len=256,
                    vision=TVisionConfig(**VISION))
N_PATCH = 4  # (28 / 14)^2
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=2,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=256)
HOST = "127.0.0.1"


def tcfg_of(jcfg):
    """The port's ModelConfig for a JAX one (its VisionConfig too)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(TModelConfig)}
    if jcfg.vision is not None:
        kw["vision"] = TVisionConfig(**dataclasses.asdict(jcfg.vision))
    return TModelConfig(**kw)


def image(seed, size=28):
    rng = np.random.RandomState(seed)
    return rng.rand(size, size, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_tree():
    eng = JNativeEngine(JCFG, JEngineConfig(**ENGINE_KW), seed=0)
    return jax.device_get(eng.params)


def engines(jax_tree, jcfg=JCFG, **kw):
    """(JAX engine, port engine) on the same weights and engine knobs."""
    ecfg = dict(ENGINE_KW, **kw)
    jeng = JNativeEngine(jcfg, JEngineConfig(**ecfg), seed=0)
    tcfg = tcfg_of(jcfg)
    teng = TNativeEngine(tcfg, TEngineConfig(**ecfg),
                         params=params_from_jax(jax_tree, tcfg),
                         device="cpu")
    return jeng, teng


def mm_prompt(pad=0):
    """[text x4] [IMG x N_PATCH] [text x4] [pad]; the span at offset 4."""
    return [5, 6, 7, 8] + [0] * N_PATCH + [9, 10, 11, 12] \
        + list(range(20, 20 + pad))


def sampling(cls, max_tokens=6):
    return cls(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)


def drive(eng, reqs):
    """{request id: tokens} of requests all added at once, stepped to the
    end."""
    for r in reqs:
        eng.add_request(r)
    out = {r.request_id: [] for r in reqs}
    while eng.has_work():
        for ev in eng.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
    return out


def both(jeng, teng, make):
    """The same requests through both engines: make(request_cls,
    sampling_cls, engine) -> requests. Returns (JAX streams, port
    streams)."""
    want = drive(jeng, make(JRequest, JSamplingParams, jeng))
    got = drive(teng, make(TRequest, TSamplingParams, teng))
    return want, got


# -- the tower ------------------------------------------------------------------

def test_patchify_exact():
    from dynamo_tpu.models import vision as jvision
    px = np.random.RandomState(0).rand(2, 56, 42, 3).astype(np.float32)
    want = np.asarray(jvision.patchify(jnp.asarray(px), 14))
    got = tvision.patchify(torch.from_numpy(px), 14).numpy()
    np.testing.assert_array_equal(got, want)
    assert tvision.num_patches(TVisionConfig(**VISION)) == N_PATCH


@pytest.mark.parametrize("geometry", [
    VISION,
    dict(image_size=56, patch_size=14, hidden_size=64,
         intermediate_size=128, num_layers=3, num_heads=4),
])
def test_encode_matches_jax(geometry):
    """The tower's output in f32 within 1e-5 of JAX's on the same weights,
    at tiny-vl and a wider geometry, one image and a batch of 3. In bf16
    (XLA-CPU and torch round bf16 products differently) within 2^-5, four
    bf16 ulps at the outputs' magnitude of about 2, and within 1% in
    relative norm."""
    from dynamo_tpu.models import vision as jvision
    s = geometry["image_size"]
    px = np.stack([image(i, s) for i in range(3)])
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2 ** -5)):
        jcfg = JModelConfig(dtype=dtype, vision=JVisionConfig(**geometry))
        tcfg = tcfg_of(jcfg)
        jtree = jax.device_get(jvision.init_params(jax.random.PRNGKey(7),
                                                   jcfg))
        dt = tllama.torch_dtype(tcfg)
        tree = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a, np.float32)).to(dt),
            jtree)
        for batch in (px[:1], px):
            want = np.asarray(jvision.encode(jtree, jcfg, jnp.asarray(batch))
                              .astype(jnp.float32))
            got = tvision.encode(tree, tcfg, torch.from_numpy(batch))
            assert got.dtype == tllama.torch_dtype(tcfg)
            assert got.shape == (len(batch),
                                 (s // geometry["patch_size"]) ** 2,
                                 jcfg.hidden_size)
            got = got.float().numpy()
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_params_bridge_and_init(jax_tree):
    """params_from_jax carries the tower exactly and refuses a tree
    without one; the port's init draws the tower after the text weights,
    from a generator of its own, so the text weights of a seed are the same
    with or without a tower; weight_bytes counts the tower."""
    t = params_from_jax(jax_tree, TCFG)
    for key in ("patch_embed", "pos_embed", "proj", "final_norm"):
        np.testing.assert_array_equal(t["vision"][key].numpy(),
                                      np.asarray(jax_tree["vision"][key]))
    for key, leaf in jax_tree["vision"]["layers"].items():
        np.testing.assert_array_equal(t["vision"]["layers"][key].numpy(),
                                      np.asarray(leaf))
    text_only = {k: v for k, v in jax_tree.items() if k != "vision"}
    with pytest.raises(ValueError, match="vision"):
        params_from_jax(text_only, TCFG)
    plain = tllama.init_params(dataclasses.replace(TCFG, vision=None),
                               "cpu", seed=3)
    vl = tllama.init_params(TCFG, "cpu", seed=3)
    assert torch.equal(plain["embed"], vl["embed"])
    assert all(torch.equal(plain["layers"][k], vl["layers"][k])
               for k in plain["layers"])
    assert torch.equal(plain["lm_head"], vl["lm_head"])
    shapes = tvision.param_shapes(TCFG)
    assert tuple(vl["vision"]["proj"].shape) == shapes["proj"]
    eng = TNativeEngine(TCFG, TEngineConfig(**ENGINE_KW), params=t,
                        device="cpu")
    tower = sum(x.numel() * x.element_size() for x in (
        list(t["vision"]["layers"].values())
        + [t["vision"][k] for k in ("patch_embed", "pos_embed", "proj",
                                    "final_norm")]))
    text = tllama.init_params(dataclasses.replace(TCFG, vision=None), "cpu")
    assert eng.metrics().weight_bytes == tower + sum(
        x.numel() * x.element_size()
        for x in [text["embed"], text["final_norm"], text["lm_head"],
                  *text["layers"].values()])


def test_encoder_shapes_and_determinism(jax_tree):
    jeng, teng = engines(jax_tree)
    e1 = teng.encode_image(image(0))
    assert e1.shape == (N_PATCH, TCFG.hidden_size) and e1.dtype == np.float32
    np.testing.assert_array_equal(e1, teng.encode_image(image(0)))
    batch = teng.encode_image(np.stack([image(0), image(1)]))
    assert batch.shape == (2, N_PATCH, TCFG.hidden_size)
    np.testing.assert_allclose(batch[0], e1, rtol=1e-5)
    np.testing.assert_allclose(e1, jeng.encode_image(image(0)), rtol=1e-5,
                               atol=1e-5)
    text = TNativeEngine(dataclasses.replace(TCFG, vision=None),
                         TEngineConfig(**ENGINE_KW), device="cpu")
    with pytest.raises(ValueError, match="no vision encoder"):
        text.encode_image(image(0))


# -- the engine -------------------------------------------------------------------

def test_image_content_changes_output(jax_tree):
    """Each engine's own embeds: the streams equal JAX's; the same image is
    deterministic and a different image changes the output."""
    jeng, teng = engines(jax_tree)

    def make(req, sp, eng):
        e_a, e_b = eng.encode_image(image(1)), eng.encode_image(image(2))
        return [req("a", mm_prompt(), sampling(sp), mm_spans=[(4, e_a)]),
                req("b", mm_prompt(), sampling(sp), mm_spans=[(4, e_b)]),
                req("a2", mm_prompt(), sampling(sp), mm_spans=[(4, e_a)])]
    want, got = both(jeng, teng, make)
    assert got == want
    assert got["a"] == got["a2"] and got["a"] != got["b"]


def test_pixels_and_embeds_requests_agree(jax_tree):
    """mm_pixels (encoded at admission, salted from the pixels) and
    mm_spans (the embeds, salted from their bytes) give the same stream,
    equal to JAX's."""
    jeng, teng = engines(jax_tree)

    def make(req, sp, eng):
        return [req("px", mm_prompt(), sampling(sp),
                    mm_pixels=[(4, image(4))]),
                req("em", mm_prompt(), sampling(sp),
                    mm_spans=[(4, eng.encode_image(image(4)))])]
    want, got = both(jeng, teng, make)
    assert got == want and got["px"] == got["em"]


def test_prefix_cache_distinguishes_images(jax_tree):
    """Admission salts the placeholder ids: different images give
    different salts, the same image the same salts (cacheable), text
    positions keep their ids, and the salts lie outside the vocabulary."""
    _, teng = engines(jax_tree)
    e_a, e_b = teng.encode_image(image(1)), teng.encode_image(image(2))
    sch = teng.scheduler
    s_a = sch._admit(TRequest("pa", mm_prompt(), sampling(TSamplingParams),
                              mm_spans=[(4, e_a)]))
    s_b = sch._admit(TRequest("pb", mm_prompt(), sampling(TSamplingParams),
                              mm_spans=[(4, e_b)]))
    s_a2 = sch._admit(TRequest("pa2", mm_prompt(),
                               sampling(TSamplingParams),
                               mm_spans=[(4, e_a)]))
    span = slice(4, 4 + N_PATCH)
    assert s_a.prompt[span] != s_b.prompt[span]
    assert s_a.prompt == s_a2.prompt
    assert s_a.prompt[:4] == s_b.prompt[:4] == [5, 6, 7, 8]
    assert s_a.prompt[8:] == [9, 10, 11, 12]
    salts = s_a.prompt[span]
    assert salts == [salts[0] + j for j in range(N_PATCH)]
    assert all(not 0 <= x < TCFG.vocab_size for x in salts)
    for rid in ("pa", "pb", "pa2"):
        sch.params.pop(rid, None)
    # a span past the prompt is this request's ValueError
    with pytest.raises(ValueError, match="outside prompt"):
        sch._admit(TRequest("bad", mm_prompt()[:6],
                            sampling(TSamplingParams), mm_spans=[(4, e_a)]))


def test_span_positions_exempt_from_vocab_check(jax_tree):
    _, teng = engines(jax_tree)
    emb = teng.encode_image(image(1))
    prompt = mm_prompt()
    prompt[5] = 10 ** 6          # inside the span: a placeholder, fine
    teng.add_request(TRequest("ok", prompt, sampling(TSamplingParams),
                              mm_spans=[(4, emb)]))
    prompt = mm_prompt()
    prompt[9] = 10 ** 6          # a text position: refused
    with pytest.raises(ValueError, match="outside the model vocab"):
        teng.add_request(TRequest("bad", prompt, sampling(TSamplingParams),
                                  mm_spans=[(4, emb)]))


def test_image_span_straddles_prefill_chunks(jax_tree):
    """A span over the 16-token chunk boundary (prompt [14, 18)) gives the
    single-chunk stream, in both packages, and the embeds change it."""
    prompt = list(range(30, 44)) + [0] * N_PATCH + list(range(50, 74))

    def make(req, sp, eng):
        return [req("s", prompt, sampling(sp),
                    mm_spans=[(14, eng.encode_image(image(3)))])]
    wide = dict(max_prefill_chunk=64, prefill_buckets=(8, 16, 32, 64))
    want, got_whole = both(*engines(jax_tree, **wide), make)
    assert got_whole == want
    raw = engines(jax_tree, **wide)[1].generate(
        prompt, sampling(TSamplingParams), "raw")
    assert got_whole["s"] != raw
    jeng, teng = engines(jax_tree, max_prefill_chunk=16,
                         prefill_buckets=(8, 16))
    want, got = both(jeng, teng, make)
    assert got == want == got_whole


def test_prefix_hit_ending_inside_span(jax_tree):
    """The same leading text and image twice, with the span over the
    first page boundary ([6, 10) at page size 8): the second request hits
    one page and its first chunk starts mid-span, slicing the embeds from
    row 2. Streams and prefix hits equal JAX's, and the second stream is
    the one a cold engine gives."""
    head = [5, 6, 7, 8, 9, 10] + [0] * N_PATCH
    first, second = head + [11, 12, 13], head + [14, 15, 16, 17]

    def make(req, sp, eng):
        emb = eng.encode_image(image(6))
        return [req("one", first, sampling(sp), mm_spans=[(6, emb)])]

    def again(req, sp, eng):
        emb = eng.encode_image(image(6))
        return [req("two", second, sampling(sp), mm_spans=[(6, emb)])]
    jeng, teng = engines(jax_tree)
    want, got = both(jeng, teng, make)
    assert got == want
    seen = []
    orig = teng.scheduler._build_prefill

    def spy(batch, tb, decode_rows=()):
        plan = orig(batch, tb, decode_rows)
        seen.extend((s.num_cached, plan.mm_mask is not None)
                    for s, _, _ in batch)
        return plan
    teng.scheduler._build_prefill = spy
    want, got = both(jeng, teng, again)
    assert got == want
    assert seen[0] == (8, True)
    assert teng.scheduler._prefix_hits == jeng.scheduler._prefix_hits >= 1
    cold = drive(engines(jax_tree)[1], again(TRequest, TSamplingParams,
                                             teng))
    assert cold == got


def test_image_chunk_in_mixed_step(jax_tree):
    """An image prompt admitted while a text request decodes: its chunk
    rides a mixed step with the decode row, carrying its embeds."""
    jeng, teng = engines(jax_tree, mixed_token_budget=64)
    mixed_mm = []
    orig = teng._run_mixed

    def spy(plan):
        mixed_mm.append(plan.mm_embeds is not None)
        return orig(plan)
    teng._run_mixed = spy

    def run(eng, req, sp):
        eng.add_request(req("text", list(range(40, 52)),
                            sampling(sp, max_tokens=24)))
        out = {"text": [], "img": []}
        steps = 0
        while eng.has_work():
            if steps == 2:
                eng.add_request(req("img", mm_prompt(pad=6), sampling(sp),
                                    mm_pixels=[(4, image(8))]))
            for ev in eng.step():
                if ev.token is not None:
                    out[ev.request_id].append(ev.token)
            steps += 1
        return out
    want = run(jeng, JRequest, JSamplingParams)
    got = run(teng, TRequest, TSamplingParams)
    assert got == want
    assert any(mixed_mm) and teng.mixed_steps == jeng.mixed_steps > 0


def test_preempted_image_sequence_recomputes(jax_tree):
    """A tiny page pool preempts a running image sequence; its recompute
    mixes the span back in from the sequence's spans, and the streams
    equal an un-preempted engine's and JAX's."""
    kw = dict(num_pages=9, max_prefill_chunk=16, prefill_buckets=(8, 16))

    def make(req, sp, eng):
        return [req(f"r{i}", mm_prompt(pad=4), sampling(sp, max_tokens=20),
                    mm_pixels=[(4, image(10 + i))]) for i in range(2)]
    jeng, teng = engines(jax_tree, **kw)
    evictions = []
    orig = teng.scheduler._evict_to_waiting

    def spy(victim):
        evictions.append((victim.request_id, bool(victim.mm_spans)))
        return orig(victim)
    teng.scheduler._evict_to_waiting = spy
    want, got = both(jeng, teng, make)
    assert got == want
    assert evictions and all(mm for _, mm in evictions)
    roomy = drive(engines(jax_tree)[1], make(TRequest, TSamplingParams,
                                             teng))
    assert got == roomy


# -- the preprocessor, the wire and the worker -------------------------------------

def _npy_url(px) -> str:
    buf = io.BytesIO()
    np.save(buf, px)
    return "data:application/x-npy;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _preprocessors(arch="tiny-vl"):
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor as TPre
    return (JPre(JCard(name="vl", arch=arch, context_length=256)),
            TPre(TCard(name="vl", arch=arch, context_length=256)))


def _chat(pkg: str, messages):
    if pkg == "jax":
        from dynamo_tpu.protocols.openai import ChatCompletionRequest
        return ChatCompletionRequest(model="vl", max_tokens=4,
                                     messages=messages)
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
    return ChatCompletionRequest.from_json(
        {"model": "vl", "max_tokens": 4, "messages": messages})


def _part_fields(p) -> dict:
    return {k: getattr(p, k) for k in ("offset", "shape", "dtype", "data",
                                       "kind", "salt")}


IMAGE_CASES = {
    "data url": [{"type": "image_url",
                  "image_url": {"url": _npy_url(image(7))}}],
    "pixel list": [{"type": "image", "pixels": image(7).tolist()}],
    "resize": [{"type": "image_url",
                "image_url": {"url": _npy_url(
                    np.random.RandomState(2).rand(20, 36, 3)
                    .astype(np.float32))}}],
    "0-255": [{"type": "image", "pixels": (image(5) * 255).round()
               .tolist()}],
    "two images": [{"type": "image_url",
                    "image_url": {"url": _npy_url(image(1))}},
                   {"type": "text", "text": " and "},
                   {"type": "image", "pixels": image(2).tolist()}],
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_preprocessor_image_parts_match_jax(case):
    """token_ids and every ImagePart field (the pixel bytes included)
    equal JAX's; text around an image tokenizes as the prefix; the
    placeholders sit at each part's offset."""
    from dynamo_tpu_torch.llm.preprocessor import IMAGE_PLACEHOLDER_ID
    messages = [{"role": "system", "content": "look"},
                {"role": "user", "content": [
                    {"type": "text", "text": "what is "},
                    *IMAGE_CASES[case],
                    {"type": "text", "text": "?"}]}]
    jpre, tpre = _preprocessors()
    want, _ = jpre.preprocess_chat(_chat("jax", messages), "rid")
    got, _ = tpre.preprocess_chat(_chat("torch", messages), "rid")
    assert got.token_ids == want.token_ids
    assert [_part_fields(p) for p in got.mm_parts] \
        == [_part_fields(p) for p in want.mm_parts]
    for p in got.mm_parts:
        assert p.shape == [28, 28, 3]
        assert got.token_ids[p.offset:p.offset + N_PATCH] \
            == [IMAGE_PLACEHOLDER_ID] * N_PATCH
        px = np.frombuffer(p.data, np.float32)
        assert px.min() >= 0.0 and px.max() <= 1.0
    first = got.mm_parts[0].offset
    assert got.token_ids[:first] == tpre.tokenizer.encode(
        "<|system|>look</s><|user|>what is ")


def test_preprocessor_marker_and_text_only():
    """A user's text cannot inject the image marker; text-only content
    parts render as their text; a text-only model refuses image parts."""
    from dynamo_tpu_torch.llm.preprocessor import IMAGE_MARKER
    messages = [{"role": "user", "content": [
        {"type": "text", "text": f"a{IMAGE_MARKER}b "},
        {"type": "image", "pixels": image(3).tolist()}]},
        {"role": "assistant", "content": f"x{IMAGE_MARKER}y"},
        {"role": "user", "content": [{"type": "text", "text": "more"}]}]
    jpre, tpre = _preprocessors()
    want, _ = jpre.preprocess_chat(_chat("jax", messages), "rid")
    got, _ = tpre.preprocess_chat(_chat("torch", messages), "rid")
    assert got.token_ids == want.token_ids and len(got.mm_parts) == 1
    text_only = [{"role": "user", "content": [
        {"type": "text", "text": "only "}, {"type": "text", "text": "text"}]}]
    want, _ = jpre.preprocess_chat(_chat("jax", text_only), "rid")
    got, _ = tpre.preprocess_chat(_chat("torch", text_only), "rid")
    assert got.token_ids == want.token_ids and got.mm_parts is None
    jtxt, ttxt = _preprocessors("tiny")
    for pre, pkg in ((jtxt, "jax"), (ttxt, "torch")):
        with pytest.raises(ValueError, match="text-only"):
            pre.preprocess_chat(_chat(pkg, messages))
    bad = [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "http://x/y.png"}}]}]
    with pytest.raises(ValueError, match="data URL"):
        _preprocessors()[1].preprocess_chat(_chat("torch", bad))


def test_wire_bytes_match_jax_msgpack():
    """A PreprocessedRequest with image parts (pixels and embeds kinds) as
    the port's codec packs its wire form: the bytes the JAX package's
    msgpack gives its model_dump(exclude_none=True); and back."""
    from dynamo_tpu.protocols.common import (
        ImagePart as JImagePart, PreprocessedRequest as JPre,
        StopConditions as JStop,
    )
    from dynamo_tpu_torch.protocols.common import (
        ImagePart, PreprocessedRequest, StopConditions,
        preprocessed_from_wire, to_wire,
    )
    from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb
    px, emb = image(2), np.arange(8, dtype=np.float32).reshape(2, 4)
    parts = [dict(offset=4, shape=[28, 28, 3], data=px.tobytes()),
             dict(offset=9, shape=[2, 4], data=emb.tobytes(),
                  kind="embeds", salt=12345)]
    kw = dict(request_id="w", token_ids=mm_prompt(), mdc_sum="abc")
    jreq = JPre(stop=JStop(max_tokens=6, ignore_eos=True),
                mm_parts=[JImagePart(**p) for p in parts], **kw)
    treq = PreprocessedRequest(stop=StopConditions(max_tokens=6,
                                                   ignore_eos=True),
                               mm_parts=[ImagePart(**p) for p in parts],
                               **kw)
    raw = packb(to_wire(treq))
    assert raw == msgpack.packb(jreq.model_dump(exclude_none=True))
    back = preprocessed_from_wire(unpackb(raw))
    assert back == treq and isinstance(back.mm_parts[1], ImagePart)


def test_multimodal_worker_roundtrip(jax_tree):
    """A PreprocessedRequest with image parts through NativeEngineWorker,
    as an object and as its wire dict: the worker decodes the pixels and
    the engine encodes them; the stream is the direct engine's and JAX's."""
    from dynamo_tpu.llm.worker import NativeEngineWorker as JWorker
    from dynamo_tpu.protocols.common import (
        ImagePart as JImagePart, PreprocessedRequest as JPre,
        StopConditions as JStop,
    )
    from dynamo_tpu.runtime.engine import Context as JContext
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.protocols.common import (
        ImagePart, PreprocessedRequest, StopConditions, to_wire,
    )
    from dynamo_tpu_torch.runtime.engine import Context
    px = image(5)
    _, direct = engines(jax_tree)
    expect = drive(direct, [TRequest(
        "d", mm_prompt(), sampling(TSamplingParams),
        mm_spans=[(4, direct.encode_image(px))])])["d"]
    part = dict(offset=4, shape=list(px.shape), data=px.tobytes())

    async def port(wire: bool):
        worker = await NativeEngineWorker(engines(jax_tree)[1]).start()
        try:
            pre = PreprocessedRequest(
                request_id="w", token_ids=mm_prompt(),
                stop=StopConditions(max_tokens=6, ignore_eos=True),
                mm_parts=[ImagePart(**part)])
            toks = []
            async for f in worker.generate(to_wire(pre) if wire else pre,
                                           Context("w")):
                toks.extend(f.token_ids)
            return toks
        finally:
            await worker.stop()

    async def jax_side():
        worker = JWorker(engines(jax_tree)[0])
        await worker.start()
        try:
            pre = JPre(request_id="w", token_ids=mm_prompt(),
                       stop=JStop(max_tokens=6, ignore_eos=True),
                       mm_parts=[JImagePart(**part)])
            toks = []
            async for f in worker.generate(pre.model_dump(exclude_none=True),
                                           JContext("w")):
                toks.extend(f.get("token_ids", ()))
            return toks
        finally:
            await worker.stop()
    assert asyncio.run(port(False)) == asyncio.run(port(True)) == expect \
        == asyncio.run(jax_side())


@pytest.mark.parametrize("mm_transfer", ["pixels", "embeds"])
def test_multimodal_disagg_remote_prefill(jax_tree, mm_transfer):
    """Both transfer modes over the chunked KV transfer server: "pixels"
    ships the pixels and the prefill side encodes; "embeds" ships the
    decode side's embeds and salts and the prefill side's tower never
    runs. The request takes the remote path, the pages cross verified, and
    the stream equals the aggregated engine's and the JAX disaggregated
    run's."""
    from dynamo_tpu.disagg import (
        DisaggDecodeWorker as JDecode, DisaggregatedRouter as JRouter,
        KvTransferServer as JServer, PrefillQueue as JQueue,
        PrefillWorker as JPrefill, RemoteTransferBackend as JTransfer,
    )
    from dynamo_tpu.llm.worker import NativeEngineWorker as JWorker
    from dynamo_tpu.protocols.common import (
        ImagePart as JImagePart, PreprocessedRequest as JPre,
        StopConditions as JStop,
    )
    from dynamo_tpu.runtime.engine import Context as JContext
    from dynamo_tpu.runtime.transports.memory import MemoryPlane as JPlane
    from dynamo_tpu_torch.disagg.queue import PrefillQueue
    from dynamo_tpu_torch.disagg.remote_transfer import (
        KvTransferServer, RemoteTransferBackend,
    )
    from dynamo_tpu_torch.disagg.router import DisaggregatedRouter
    from dynamo_tpu_torch.disagg.worker import (
        DisaggDecodeWorker, PrefillWorker,
    )
    from dynamo_tpu_torch.llm.worker import NativeEngineWorker
    from dynamo_tpu_torch.protocols.common import (
        ImagePart, PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    px = image(9)
    prompt = [5, 6, 7, 8] + [0] * N_PATCH + list(range(30, 42))
    _, oracle = engines(jax_tree)
    expect = drive(oracle, [TRequest("o", prompt, sampling(TSamplingParams),
                                     mm_pixels=[(4, px)])])["o"]
    part = dict(offset=4, shape=list(px.shape), data=px.tobytes())

    def boom(*a, **k):
        raise AssertionError("prefill-side vision tower ran in embeds "
                             "transfer mode")

    async def side(port: bool):
        jeng_d, teng_d = engines(jax_tree)
        jeng_p, teng_p = engines(jax_tree)
        dec_eng, pre_eng = (teng_d, teng_p) if port else (jeng_d, jeng_p)
        if mm_transfer == "embeds":
            pre_eng.encode_image = boom
        plane = MemoryPlane() if port else JPlane()
        queue = (PrefillQueue if port else JQueue)(plane.messaging, "ns",
                                                   "tiny-vl")
        router = (DisaggregatedRouter if port else JRouter)(
            max_local_prefill_length=4, max_prefill_queue_size=8,
            model="tiny-vl")
        decode = (DisaggDecodeWorker if port else JDecode)(
            dec_eng, plane.messaging, router, queue, worker_id="dec-vl",
            prefill_timeout_s=60.0, mm_transfer=mm_transfer)
        server = await (KvTransferServer if port else JServer)(
            decode, "dec-vl").start()
        await server.register(plane.kv)
        transfer = (RemoteTransferBackend if port else JTransfer)(plane.kv)
        prefill = (PrefillWorker if port else JPrefill)(
            (NativeEngineWorker if port else JWorker)(pre_eng), queue,
            transfer, plane.messaging)
        await decode.start()
        await prefill.start()
        toks = []
        try:
            if port:
                pre = PreprocessedRequest(
                    request_id="mm1", token_ids=prompt,
                    stop=StopConditions(max_tokens=6, ignore_eos=True),
                    mm_parts=[ImagePart(**part)])
                async for f in decode.generate(pre, Context("mm1")):
                    toks.extend(f.token_ids)
            else:
                pre = JPre(request_id="mm1", token_ids=prompt,
                           stop=JStop(max_tokens=6, ignore_eos=True),
                           mm_parts=[JImagePart(**part)])
                async for f in decode.generate(
                        pre.model_dump(exclude_none=True), JContext("mm1")):
                    toks.extend(f.get("token_ids", ()))
            return toks, decode.remote_prefills
        finally:
            await prefill.stop()
            await decode.stop()
            await transfer.close()
            await server.stop()

    got = asyncio.run(asyncio.wait_for(side(True), 120))
    want = asyncio.run(asyncio.wait_for(side(False), 120))
    assert got == want == (expect, 1)


def test_mm_transfer_validated():
    from dynamo_tpu_torch.disagg.worker import DisaggDecodeWorker
    with pytest.raises(ValueError, match="mm_transfer"):
        DisaggDecodeWorker(None, None, None, None, mm_transfer="jpeg")


def test_remote_prefill_request_roundtrip_matches_jax():
    """A RemotePrefillRequest carrying image parts packs to the JAX
    queue's payload (the trace context aside) and unpacks to an equal
    dataclass with ImageParts inside."""
    from dynamo_tpu.disagg.protocols import (
        RemotePrefillRequest as JRemote,
    )
    from dynamo_tpu.protocols.common import ImagePart as JImagePart
    from dynamo_tpu_torch.disagg.protocols import RemotePrefillRequest
    from dynamo_tpu_torch.protocols.common import ImagePart
    from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb
    part = dict(offset=4, shape=[2, 4], kind="embeds", salt=7,
                data=np.ones((2, 4), np.float32).tobytes())
    kw = dict(engine_id="dec", request_id="r", token_ids=mm_prompt(),
              page_ids=[0, 1], page_size=8)
    treq = RemotePrefillRequest(mm_parts=[ImagePart(**part)], **kw)
    jdump = JRemote(mm_parts=[JImagePart(**part)], **kw).model_dump()
    assert jdump.pop("trace") is None
    raw = packb(treq.to_json())
    assert unpackb(raw) == jdump
    assert raw == msgpack.packb(jdump)
    assert RemotePrefillRequest.from_json(unpackb(raw)) == treq


# -- the HTTP frontend -----------------------------------------------------------

def test_image_chat_over_http_matches_jax(jax_tree):
    """An image chat (a data-URL part between text parts) through each
    package's HttpService -> LocalPipeline -> NativeEngineWorker on tiny-vl:
    the unary body and every SSE frame equal JAX's apart from id and
    created."""
    url = _npy_url(image(11))
    body = {"model": "vl", "max_tokens": 8, "messages": [{
        "role": "user", "content": [
            {"type": "text", "text": "describe "},
            {"type": "image_url", "image_url": {"url": url}},
            {"type": "text", "text": " briefly"}]}]}

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()
                    if k not in ("id", "created")}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    async def serve(pkg):
        if pkg == "jax":
            from dynamo_tpu.frontend.service import HttpService
            from dynamo_tpu.llm.model_card import ModelDeploymentCard
            from dynamo_tpu.llm.pipeline import LocalPipeline
            from dynamo_tpu.llm.worker import NativeEngineWorker
            engine = engines(jax_tree)[0]
            worker = NativeEngineWorker(engine)
            await worker.start()
        else:
            from dynamo_tpu_torch.frontend.service import HttpService
            from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
            from dynamo_tpu_torch.llm.pipeline import LocalPipeline
            from dynamo_tpu_torch.llm.worker import NativeEngineWorker
            worker = await NativeEngineWorker(engines(jax_tree)[1]).start()
        card = ModelDeploymentCard(name="vl", arch="tiny-vl",
                                   context_length=256)
        svc = await HttpService(HOST, 0).start()
        svc.models.add("vl", LocalPipeline(card, worker), "chat")
        try:
            status, raw = await request(HOST, svc.port, "POST",
                                        "/v1/chat/completions", body)
            assert status == 200, raw
            frames = [d async for _, d in sse_events(
                HOST, svc.port, "/v1/chat/completions",
                dict(body, stream=True))]
            assert frames[-1] == "[DONE]"
            return strip(json.loads(raw)), [strip(json.loads(d))
                                            for d in frames[:-1]]
        finally:
            await svc.stop()
            await worker.stop()
    want = asyncio.run(serve("jax"))
    got = asyncio.run(serve("torch"))
    assert got == want
    assert got[0]["choices"][0]["message"]["content"]
    assert got[0]["usage"]["prompt_tokens"] > N_PATCH
