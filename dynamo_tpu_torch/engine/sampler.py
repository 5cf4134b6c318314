"""Token sampling (greedy / temperature / top-k / top-p) in PyTorch.

Port of dynamo_tpu/engine/sampler.py. A request with a `temperature` and a
`seed` must draw the same tokens as in the JAX package, so the JAX PRNG is
reimplemented here in torch integer ops: threefry2x32 keys
`PRNGKey(0) -> fold_in(seed) -> fold_in(counter)` (`make_keys`), and
`jax.random.categorical`'s Gumbel-argmax with `jax.random.uniform`'s
bit-to-float mapping over the partitionable threefry bit stream
(`jax_threefry_partitionable=True`, the default of the JAX versions the
reference runs). A `torch.Generator` cannot reproduce those draws.

Uint32 arithmetic runs in int64 tensors masked to 32 bits, which works on
every device torch supports.

`sample_logits` and the samplers copy nothing between host and device and
never wait on the device, so the engine can capture them in a CUDA graph:
constants are Python scalars or filled on the device, and the eos ban takes
a [V] mask the engine builds once (`eos_mask`).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# static top-k width for logprob alternatives
TOP_LOGPROBS = 8

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _slot_key(reqs) -> tuple:
    """Cache key for a slot set: (request_id, epoch) per slot."""
    return tuple((s.request_id, s.epoch) if s is not None else None
                 for s in reqs)


class SamplingArrayCache:
    """Host staging for per-slot sampling parameter arrays.

    Parameters are immutable per request, so the static block (temperature,
    top_k, top_p, seed, min_tokens) is rebuilt only when the slot ->
    request mapping changes; the per-step counters column (tokens emitted
    so far) is built per call."""

    def __init__(self):
        self._key = None
        self._static = None
        self._greedy = True
        self._fusable = True

    def arrays(self, reqs, params_of):
        """(temp, top_k, top_p, seeds, counters, min_toks) float32/int32
        numpy arrays, one row per slot; params_of maps request_id ->
        SamplingParams."""
        key = _slot_key(reqs)
        if key != self._key:
            n = len(reqs)
            temp = np.zeros((n,), np.float32)
            top_k = np.zeros((n,), np.int32)
            top_p = np.ones((n,), np.float32)
            seeds = np.zeros((n,), np.int32)
            min_toks = np.zeros((n,), np.int32)
            for i, seq in enumerate(reqs):
                if seq is None:
                    continue
                p = params_of(seq.request_id)
                temp[i] = p.temperature
                top_k[i] = p.top_k
                top_p[i] = p.top_p
                seeds[i] = p.seed & 0x7FFFFFFF
                min_toks[i] = p.min_tokens
            self._static = (temp, top_k, top_p, seeds, min_toks)
            self._greedy = bool(np.all(temp <= 0.0))
            self._fusable = bool(np.all(top_p >= 1.0))
            self._key = key
        temp, top_k, top_p, seeds, min_toks = self._static
        counters = np.fromiter(
            (len(s.output) if s is not None else 0 for s in reqs),
            np.int32, count=len(reqs))
        return temp, top_k, top_p, seeds, counters, min_toks

    @property
    def all_greedy(self) -> bool:
        """Every slot in the last-built set samples greedily."""
        return self._greedy

    @property
    def fused_eligible(self) -> bool:
        """Every slot in the last-built set has top_p disabled (== 1.0), so
        the top_p-free `sample_fused` draws the same tokens as `sample`."""
        return self._fusable


class RepPenaltyCache:
    """Incremental host staging for repetition-penalty history rows: each
    sequence's seen tokens (prompt + generated), padded with vocab_size.
    The block persists across steps; on a slot-set hit only newly generated
    tokens are appended."""

    def __init__(self):
        self._key = None
        self._any = False
        self._pens = None
        self._hist = None
        self._filled = None   # tokens already staged per row

    @staticmethod
    def _tail(seq, start: int):
        """seq.all_tokens[start:] without materialising the full concat."""
        n_prompt = len(seq.prompt)
        if start < n_prompt:
            return seq.prompt[start:] + seq.output
        return seq.output[start - n_prompt:]

    def arrays(self, reqs, params_of, vocab_size: int, bucket_of):
        """(hist [S, Hb], rep_penalty [S]) or None when no slot penalises.
        bucket_of maps a length to its padded bucket Hb."""
        key = _slot_key(reqs)
        if key != self._key:
            pens = np.ones((len(reqs),), np.float32)
            self._any = False
            for i, seq in enumerate(reqs):
                if seq is None:
                    continue
                rp = params_of(seq.request_id).repetition_penalty
                if rp and rp != 1.0:
                    self._any = True
                    pens[i] = rp
            self._pens = pens
            self._hist = None
            self._filled = None
            self._key = key
        if not self._any:
            return None
        longest = max((s.total_len for s in reqs if s is not None),
                      default=1)
        hb = bucket_of(max(1, longest))
        if self._hist is None or hb > self._hist.shape[1]:
            self._hist = np.full((len(reqs), hb), vocab_size, np.int32)
            self._filled = np.zeros((len(reqs),), np.int64)
        hist, filled = self._hist, self._filled
        for i, seq in enumerate(reqs):
            if seq is None:
                continue
            have, want = int(filled[i]), seq.total_len
            if want > have:
                hist[i, have:want] = self._tail(seq, have)
                filled[i] = want
        return hist, self._pens


def seen_token_mask(hist: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, Hb] token-id history (pad >= vocab) -> [B, V] presence mask."""
    b = hist.shape[0]
    idx = torch.clamp(hist.long(), max=vocab)   # pads land in column V
    mask = torch.zeros((b, vocab + 1), dtype=torch.bool, device=hist.device)
    mask.scatter_(1, idx, True)
    return mask[:, :vocab]


def apply_repetition_penalty(logits, seen, penalty):
    """HF/vLLM semantics: for tokens already seen (prompt + generated),
    divide positive logits by the penalty, multiply negative ones."""
    p = torch.clamp(penalty, min=1e-6)[:, None]
    pen = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen, pen, logits)


def compute_logprobs(logits, sampled):
    """Per-row logprob of the sampled token + top-K alternatives over the
    unmodified (pre-temperature) distribution: (sampled_lp [B],
    top_ids [B, K] int32, top_lps [B, K])."""
    logp = torch.log_softmax(logits, dim=-1)
    samp = logp.gather(1, sampled.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(logp, TOP_LOGPROBS, dim=-1)
    return samp, top_ids.to(torch.int32), top_lps


# -- the JAX PRNG in torch integer ops ----------------------------------------

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds), as jax.random's threefry2x32 primitive:
    keys and counts are int64 tensors holding uint32 values; returns the
    two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def make_keys(seeds: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Per-row PRNG keys [B, 2] (uint32 values in int64), deterministic in
    (request seed, token index): the key data of
    fold_in(fold_in(PRNGKey(0), seed), counter). fold_in(key, d) is
    threefry2x32(key, (0, d))."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    k1, k2 = threefry2x32(zero, zero, zero, seeds.long() & _MASK32)
    k1, k2 = threefry2x32(k1, k2, zero, counters.long() & _MASK32)
    return torch.stack([k1, k2], dim=-1)


def _uniform01(keys: torch.Tensor, v: int) -> torch.Tensor:
    """jax.random.uniform(key, (v,), float32, minval=tiny, maxval=1) per
    row of keys [B, 2]: partitionable threefry bits (counter = element
    index split into hi/lo words, bits = out0 ^ out1), the top 23 bits as
    the mantissa of a float in [1, 2), minus 1, scaled and clamped."""
    idx = torch.arange(v, dtype=torch.int64, device=keys.device)
    k1 = keys[:, 0:1]
    k2 = keys[:, 1:2]
    b1, b2 = threefry2x32(k1, k2, (idx >> 32)[None, :] & _MASK32,
                          (idx & _MASK32)[None, :])
    bits = ((b1 ^ b2) >> 9) | 0x3F800000        # 1.0f's exponent
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # maxval - minval rounds to 1.0 in f32, as in jax.random.uniform
    return torch.clamp(f * (1.0 - _TINY_F32) + _TINY_F32, min=_TINY_F32)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical per row: argmax(logits + Gumbel noise), the
    noise -log(-log(u)) from `_uniform01`."""
    u = _uniform01(keys, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)


# -- samplers ------------------------------------------------------------------

def _descending_order(scaled):
    """The JAX package's descending order: a stable ascending argsort,
    reversed (ties end up highest index first)."""
    return torch.argsort(scaled, dim=-1, stable=True).flip(-1)


def _ranks_of(order):
    """Inverse permutation of `order` per row: ranks[order[j]] = j."""
    iota = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, iota)


def sample(logits, temperature, top_k, top_p, keys):
    """logits [B, V] f32; temperature [B] (0 => greedy); top_k [B] (0 =>
    disabled); top_p [B] (1.0 => disabled); keys [B, 2]. Returns [B]
    int32."""
    b, v = logits.shape
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    order = _descending_order(scaled)
    sorted_logits = scaled.gather(-1, order)
    ranks = _ranks_of(order)
    k = torch.where(top_k > 0, top_k, v)[:, None]
    keep_k = ranks < k
    # top-p: keep the smallest prefix of sorted probs with cumsum >= top_p,
    # always keeping the argmax
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    sorted_keep = (cumprobs - sorted_probs) < top_p[:, None]
    keep_p = sorted_keep.gather(-1, ranks)
    masked = torch.where(keep_k & keep_p, scaled,
                         torch.full((), NEG_INF, device=logits.device))
    sampled = categorical(keys, masked)
    return torch.where(temperature <= 0.0, greedy_tok, sampled).to(torch.int32)


def sample_fused(logits, temperature, top_k, keys):
    """The top_p-free sampling tail: temperature + top-k only. Valid only
    when every row's top_p is 1.0; draws the same token as `sample` there
    (same ranks, all-true top-p mask, same key stream)."""
    b, v = logits.shape
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    ranks = _ranks_of(_descending_order(scaled))
    k = torch.where(top_k > 0, top_k, v)[:, None]
    masked = torch.where(ranks < k, scaled,
                         torch.full((), NEG_INF, device=logits.device))
    sampled = categorical(keys, masked)
    return torch.where(temperature <= 0.0, greedy_tok, sampled).to(torch.int32)


def eos_mask(eos_ids, vocab: int, device) -> torch.Tensor:
    """[V] bool mask of the eos ids, or None when there are none. Built once
    per engine (the JAX window builds its `eos_vec` once per program): the
    index copy from a Python list must not run inside a captured window."""
    if not eos_ids:
        return None
    mask = torch.zeros((vocab,), dtype=torch.bool, device=device)
    mask[torch.tensor(sorted(eos_ids), device=device)] = True
    return mask


def sample_logits(logits, eos, temperature, top_k, top_p, seeds,
                  counters, min_tokens, seen=None, rep_penalty=None,
                  with_lp=False, greedy=False, fused=False):
    """Shared tail of every engine step: repetition penalty (optional) +
    eos ban below min_tokens + sample (+ logprobs when with_lp).

    `eos` is the engine's [V] bool mask from `eos_mask` (None = no eos), or
    a tuple of eos ids, turned into that mask here (outside a captured
    window only). Returns (tokens [B] int32, sampled_lp [B], top_ids
    [B, K], top_lps [B, K]); the lp outputs are None unless with_lp.
    Logprobs are taken over the penalised, pre-temperature, pre-ban
    distribution."""
    if not isinstance(eos, torch.Tensor):
        eos = eos_mask(eos, logits.shape[-1], logits.device)
    if rep_penalty is not None:
        logits = apply_repetition_penalty(logits, seen, rep_penalty)
    basis = logits
    if eos is not None:
        ban = (counters < min_tokens)[:, None]      # [B, 1]
        logits = torch.where(ban & eos[None, :],
                             torch.full((), NEG_INF, device=logits.device),
                             logits)
    if greedy:
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
    elif fused:
        toks = sample_fused(logits, temperature, top_k,
                            make_keys(seeds, counters))
    else:
        toks = sample(logits, temperature, top_k, top_p,
                      make_keys(seeds, counters))
    if not with_lp:
        return toks, None, None, None
    samp_lp, top_ids, top_lps = compute_logprobs(basis, toks)
    return toks, samp_lp, top_ids, top_lps
