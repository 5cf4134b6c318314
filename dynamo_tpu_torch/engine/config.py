"""Model + engine configuration.

Copied from dynamo_tpu/engine/config.py and trimmed to what the port's
slices serve: dense Llama-family models on one device. The model
registry keeps the dense Llama geometries; the engine knobs keep paging,
batching, the decode window, mixed steps and int8 KV pages (`kv_quant`).
`quant` keeps the JAX meaning (weight-only int8, ops/quant.py).
The port always runs its decode through the hand-written kernel, so there
is no `decode_kernel` knob; configs whose decode the kernel cannot serve
(attention soft-caps, sliding windows, query-scale overrides) are rejected
with NotImplementedError by `check_supported`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for a dense decoder-only transformer."""

    name: str = "tiny"
    vocab_size: int = 256
    hidden_size: int = 128
    intermediate_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    # Gemma-2 attention knobs the decode kernel has no hooks for; kept so a
    # config that sets them is refused by name instead of served wrongly
    attn_softcap: float = 0.0
    query_scale: float = 0.0
    sliding_window: int = 0
    max_model_len: int = 2048
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # weight-only quantization for serving (ops/quant.py): "" = weights in
    # `dtype`; "int8" = the seven projections and lm_head as int8 with
    # per-output-channel f32 scales (about half the bytes of bf16)
    quant: str = ""
    # KV-cache page quantization (ops/kv_quant.py): "" = pages in `dtype`,
    # "int8" = int8 pages with one f32 scale per row. A non-empty
    # EngineConfig.kv_quant overrides it at engine construction.
    kv_quant: str = ""

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configs the port cannot serve."""
    if cfg.attn_softcap or cfg.sliding_window or cfg.query_scale:
        raise NotImplementedError(
            f"model {cfg.name!r} uses attention soft-caps / sliding windows /"
            " query-scale overrides; the ragged decode kernel has no hooks "
            "for them and the port has no gather decode path")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_heads {cfg.num_heads} is not a multiple of "
                         f"num_kv_heads {cfg.num_kv_heads}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving engine knobs (continuous batching, paging, buckets).

    Field meanings and defaults are those of the JAX package's EngineConfig."""

    page_size: int = 64                 # tokens per KV page
    num_pages: int = 512                # device pages per engine
    max_slots: int = 8                  # concurrent decode slots
    max_prefill_chunk: int = 512        # longest single prefill step
    prefill_buckets: tuple = (16, 32, 64, 128, 256, 512)
    # waiting sequences whose next chunk fits the same token bucket prefill
    # together in one device step; 1 = one sequence per step
    max_prefill_batch: int = 8
    max_model_len: int = 2048
    # host-DRAM KV tier capacity in pages (0 = tier off); evicted HBM pages
    # spill here and return on prefix hits (engine/offload.py)
    host_pages: int = 0
    # disk tier below DRAM: DRAM evictions spill down, prefix hits promote
    # back up. Requires host_pages > 0. disk_dir None = a temp directory.
    disk_pages: int = 0
    disk_dir: Optional[str] = None
    # decode steps run per window: the sampled token feeds the next step on
    # the device, and the window's tokens cross to the host in one copy
    decode_steps: int = 8
    # Sarathi-style mixed prefill+decode steps: device compute tokens per
    # step (rows x token bucket); 0 = alternating prefill/decode steps
    mixed_token_budget: int = 512
    # bounded skip-ahead past a blocked head of the prefill queue
    prefill_skip_ahead: int = 4
    # alternating scheduler only (mixed_token_budget=0): longest run of
    # prefill steps while decodes are active; 0 = unbounded
    max_prefill_streak: int = 2
    # KV-cache page quantization, the deployment knob: "" keeps the model
    # config's mode, "int8" stores int8 pages + per-row f32 scales (about
    # half the bytes per page; ops/kv_quant.py)
    kv_quant: str = ""
    # decode pipeline depth: 2 = the overlapped host/device loop (the engine
    # dispatches the follow-up window from the device carry, then fetches
    # and commits the in-flight one while the device runs it); 1 = the fully
    # synchronous dispatch -> fetch -> commit loop. Streams are
    # token-identical at any depth: the engine falls back to a synchronous
    # window whenever a commit changes slot membership, and logprob /
    # repetition-penalty plans never pipeline. Values > 2 only deepen the
    # scheduler's page lookahead.
    pipeline_depth: int = 2


# -- named architectures ------------------------------------------------------

_CONFIGS = {
    # test-size model
    "tiny": ModelConfig(),
    # Llama-3.2-1B-class
    "llama3-1b": ModelConfig(
        name="llama3-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500000.0, max_model_len=8192,
    ),
    # DeepSeek-R1-Distill-Llama-8B == Llama-3.1-8B architecture
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_model_len=16384,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_model_len=16384,
    ),
}


def get_model_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]
