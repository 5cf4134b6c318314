"""Two bench phases of the JAX package's `bench.py`, ported for the port:
the int8 KV parity gate and the decode-kernel A/B.

- `run_kv_quant_parity` (root bench.py:538): kv_quant="int8" against the
  unquantized twin, teacher-forced, with the same thresholds
  (KVQ_MATCH_MIN, KVQ_DRIFT_RTOL, KVQ_DRIFT_ATOL).
- `run_decode_kernel_ab` (root bench.py:800): one decode step (paged
  attention -> head projection -> sampling tail) with the legacy kernel,
  the unified ragged kernel, and the unified kernel with the fused sampling
  tail; the three arms must sample identical tokens.

Both run where their tensors are: on a CUDA device they launch the port's
CUDA kernels, on the CPU the kernels' plain versions. Nothing here imports
the root bench.py.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# kv_quant parity gate thresholds, the JAX package's: the logit drift must
# stay under atol + rtol * max|logit|, and the DECISIVE greedy-match rate
# (argmax agreement at positions whose reference top-2 margin exceeds 2x
# the drift bound, where a bounded perturbation can never legitimately flip
# the choice) must be >= KVQ_MATCH_MIN
KVQ_MATCH_MIN = 0.99
KVQ_DRIFT_RTOL = 0.05
KVQ_DRIFT_ATOL = 0.05

# the measurement engine geometry of the JAX package's bench (PAGE_KWARGS)
PAGE_KWARGS = dict(
    page_size=64, num_pages=256, max_slots=8, max_prefill_chunk=128,
    prefill_buckets=(128,), max_model_len=2048, max_prefill_batch=8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_kv_quant_parity(model_cfg, engine_kwargs=None, n_tokens=64,
                        n_prompts=3, logf=print, params=None, device="cuda"):
    """kv_quant="int8" exactness gate: TEACHER-FORCED greedy-match rate
    against the unquantized twin, plus bounded logit drift.

    The reference engine (unquantized pages) free-runs n_tokens greedily
    per prompt; then both representations replay the same (prompt +
    reference continuation) through one prefill-shaped forward over the
    same weights, pages written (quantized for int8) and read back by the
    chunk's own causal attention: the codec round trip at every position.
    The match rate is per-position argmax agreement at each decision point,
    free of the cascade a free-running stream would add; drift is the max
    abs logit difference there, bounded by KVQ_DRIFT_ATOL + KVQ_DRIFT_RTOL
    * max|logit|.

    `params` are the weights of both (llama.init_params(model_cfg, device,
    seed=0) when None). Returns {pass, greedy_match_rate, raw_match_rate,
    decisive_positions, max_logit_drift, drift_bound, n_tokens,
    per_prompt}."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine, resolve_device
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.llama import AttnMetadata

    dev = resolve_device(device)
    kw = dict(engine_kwargs or PAGE_KWARGS)
    cfg_ref = dataclasses.replace(model_cfg, kv_quant="")
    pmod = min(1000, model_cfg.vocab_size - 2)
    prompts = [[(31 * j + 97 * i) % pmod + 1 for j in range(48)]
               for i in range(n_prompts)]
    sp = SamplingParams(max_tokens=n_tokens, temperature=0.0,
                        ignore_eos=True)

    # teacher streams from the real unquantized engine
    ref_eng = NativeEngine(cfg_ref, EngineConfig(**kw), params=params,
                           seed=0, device=dev)
    prm = ref_eng.params
    refs = [ref_eng.generate(p, sp, f"kvq-ref-{i}")
            for i, p in enumerate(prompts)]
    del ref_eng   # free its cache before the replay forwards
    cfg_q = dataclasses.replace(model_cfg, kv_quant="int8")
    ps = kw.get("page_size", 64)

    def replay_logits(cfg, seq):
        t = len(seq)
        n_pages = -(-t // ps)
        row = torch.arange(t, dtype=torch.int32, device=dev)[None]
        meta = AttnMetadata(
            positions=row,
            page_table=torch.arange(n_pages, dtype=torch.int32,
                                    device=dev)[None],
            kv_lens=torch.tensor([t], dtype=torch.int32, device=dev),
            write_idx=row)
        # one page past the table: the scratch page
        cache = llama.init_cache(cfg, n_pages + 1, ps, dev)
        tokens = torch.tensor([seq], dtype=torch.int32, device=dev)
        with torch.no_grad():
            lg = llama.forward(prm, cfg, tokens, cache, meta)[0]
        return lg[0].float().cpu().numpy()

    rows = []
    for prompt, ref in zip(prompts, refs):
        seq = list(prompt) + list(ref)
        lg_ref = replay_logits(cfg_ref, seq)
        lg_q = replay_logits(cfg_q, seq)
        lo, hi = len(prompt) - 1, len(seq) - 1
        a = lg_ref[lo:hi]
        agree = a.argmax(axis=-1) == lg_q[lo:hi].argmax(axis=-1)
        top2 = np.sort(a, axis=-1)[:, -2:]
        rows.append((top2[:, 1] - top2[:, 0], agree,
                     float(np.abs(lg_q[lo:hi] - a).max()),
                     float(np.abs(a).max())))
    drift = max(r[2] for r in rows)
    bound = KVQ_DRIFT_ATOL + KVQ_DRIFT_RTOL * max(r[3] for r in rows)
    margins = np.concatenate([r[0] for r in rows])
    agree = np.concatenate([r[1] for r in rows])
    total = len(agree)
    raw_rate = float(agree.mean()) if total else 1.0
    # decisive positions: a flip where the top-2 margin exceeds what a
    # bound-respecting perturbation could flip is a codec bug
    decisive = margins > 2 * bound
    dec_rate = float(agree[decisive].mean()) if decisive.any() else 1.0
    ok = dec_rate >= KVQ_MATCH_MIN and drift <= bound
    logf(f"kv_quant parity (teacher-forced): decisive greedy match "
         f"{dec_rate:.4f} over {int(decisive.sum())}/{total} decisive "
         f"positions (min {KVQ_MATCH_MIN}; raw incl. near-ties "
         f"{raw_rate:.4f}), logit drift {drift:.4f} (bound {bound:.4f}) "
         f"-> {'OK' if ok else 'FAIL'}")
    return {"pass": ok, "greedy_match_rate": round(dec_rate, 4),
            "raw_match_rate": round(raw_rate, 4),
            "decisive_positions": int(decisive.sum()),
            "max_logit_drift": round(drift, 5),
            "drift_bound": round(bound, 5), "n_tokens": total,
            "per_prompt": [round(float(r[1].mean()), 4) for r in rows]}


def decode_ab_inputs(model_cfg, rows=8, page_size=64, pb=4):
    """The decode A/B's inputs as numpy arrays, drawn as the JAX package's
    phase draws them (default_rng(18), same order and shapes): q, k, v,
    page table, lens, head weights, temperature, top_k, top_p."""
    s = rows
    h, hkv, hd = (model_cfg.num_heads, model_cfg.num_kv_heads,
                  model_cfg.head_dim)
    p = s * pb
    rng = np.random.default_rng(18)
    f32 = np.float32
    q = rng.standard_normal((s, h, hd)).astype(f32)
    k = rng.standard_normal((hkv, p, page_size, hd)).astype(f32)
    v = rng.standard_normal((hkv, p, page_size, hd)).astype(f32)
    pt = np.arange(s * pb, dtype=np.int32).reshape(s, pb)
    lens = rng.integers(1, pb * page_size, s).astype(np.int32)
    w_head = (rng.standard_normal((h * hd, model_cfg.vocab_size))
              * 0.05).astype(f32)
    return {"q": q, "k": k, "v": v, "pt": pt, "lens": lens,
            "w_head": w_head, "temp": np.full((s,), 0.8, f32),
            "top_k": np.full((s,), 40, np.int32),
            "top_p": np.ones((s,), f32)}


def run_decode_kernel_ab(model_cfg, base_kwargs=None, *, rows=8, reps=30,
                         logf=print, device="cuda"):
    """Legacy kernel vs unified ragged kernel vs unified + fused sampling
    tail, one decode step each, token identity enforced in the phase.

    Each arm: paged attention over ragged lengths (f32, the model's head
    geometry, ps from base_kwargs, 4 pages per row) -> a head projection to
    the vocabulary -> the sampling tail (temperature 0.8, top_k 40, top_p
    1, keys from make_keys(arange(rows), 0)). Arms: "legacy" (the legacy
    kernel + the unfused tail), "unified" (the ragged kernel in inclusive
    mode + the unfused tail), "unified_fused" (the ragged kernel + the
    fused tail, what a decode window runs per step). All three must sample
    IDENTICAL tokens. Step times are means over `reps` steps per arm after
    one warm-up step each, timed in turns (the arms in order, then in
    reverse, reps / 2 steps each time) on the host clock with a device
    synchronise at both ends.

    Returns the JAX phase's keys (rows, heads, kv_heads, head_dim,
    page_size, interpret, legacy/unified/unified_fused_step_ms, their two
    ratios, tokens_identical) plus "device" and the arms' "tokens"."""
    from dynamo_tpu_torch.engine import sampler
    from dynamo_tpu_torch.engine.engine import resolve_device
    from dynamo_tpu_torch.ops.paged_attention import decode_paged_attention
    from dynamo_tpu_torch.ops.paged_attention_oracle import (
        decode_paged_attention_legacy,
    )

    dev = resolve_device(device)
    kw = dict(base_kwargs or PAGE_KWARGS)
    arrs = decode_ab_inputs(model_cfg, rows, kw["page_size"])
    t = {k: torch.from_numpy(a).to(dev) for k, a in arrs.items()}
    s, h, hd = arrs["q"].shape
    keys = sampler.make_keys(torch.arange(s, dtype=torch.int32, device=dev),
                             torch.zeros((s,), dtype=torch.int32, device=dev))

    def make_step(kernel, fused):
        def step():
            attn = kernel(t["q"], t["k"], t["v"], t["pt"], t["lens"])
            logits = attn.reshape(s, h * hd) @ t["w_head"]
            if fused:
                return sampler.sample_fused(logits, t["temp"], t["top_k"],
                                            keys)
            return sampler.sample(logits, t["temp"], t["top_k"], t["top_p"],
                                  keys)
        return step

    arms = {
        "legacy": make_step(decode_paged_attention_legacy, False),
        "unified": make_step(decode_paged_attention, False),
        "unified_fused": make_step(decode_paged_attention, True),
    }
    toks = {}
    spent = {name: 0.0 for name in arms}
    with torch.no_grad():
        for name, fn in arms.items():
            toks[name] = fn().cpu().numpy()          # warm-up + identity
        # timed in turns, the arms' order then its reverse, so drift over
        # the phase does not fall on one arm
        half = max(1, reps // 2)
        for order in (list(arms), list(arms)[::-1]):
            for name in order:
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(half):
                    arms[name]()
                _sync(dev)
                spent[name] += time.perf_counter() - t0
    ms = {name: t / (2 * half) * 1e3 for name, t in spent.items()}
    identical = bool(np.array_equal(toks["legacy"], toks["unified"])
                     and np.array_equal(toks["unified"],
                                        toks["unified_fused"]))
    # token identity is the phase's correctness gate, not a soft metric
    assert identical, {k: v.tolist() for k, v in toks.items()}
    res = {
        "rows": s, "heads": h, "kv_heads": model_cfg.num_kv_heads,
        "head_dim": hd, "page_size": kw["page_size"],
        "interpret": dev.type != "cuda", "device": str(dev),
        "legacy_step_ms": round(ms["legacy"], 4),
        "unified_step_ms": round(ms["unified"], 4),
        "unified_fused_step_ms": round(ms["unified_fused"], 4),
        "unified_legacy_step_ratio": round(
            ms["unified"] / ms["legacy"], 4) if ms["legacy"] else None,
        "fused_unfused_step_ratio": round(
            ms["unified_fused"] / ms["unified"], 4)
        if ms["unified"] else None,
        "tokens_identical": identical,
        "tokens": {k: v.tolist() for k, v in toks.items()},
    }
    logf(f"decode kernel A/B ({dev.type}, {model_cfg.name} geometry): "
         f"legacy {ms['legacy']:.4f} ms -> unified {ms['unified']:.4f} ms "
         f"(ratio {res['unified_legacy_step_ratio']}), fused tail "
         f"{ms['unified_fused']:.4f} ms "
         f"(ratio {res['fused_unfused_step_ratio']}); tokens identical")
    return res
