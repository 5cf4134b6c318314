"""Model + engine configuration.

Copied from dynamo_tpu/engine/config.py and trimmed to what the port's
slices serve: Llama-family models on one device, dense or mixture-of-
experts (Mixtral-style top-k routing, ops/moe.py), with or without a ViT
vision tower (`VisionConfig`, models/vision.py). The model registry is the
JAX registry: the dense Llama geometries, the MoE ones (`tiny-moe`,
`mixtral-8x7b`) and the vision ones (`tiny-vl`, `qwen2-vl-7b`); the engine
knobs keep paging,
batching, the decode window, mixed steps, int8 KV pages (`kv_quant`),
speculative decoding (`spec_*`, engine/spec.py) and KV streaming past the
page budget (`stream_*`, engine/streaming.py).
`quant` keeps the JAX meaning (weight-only int8, ops/quant.py).
The architecture knobs the checkpoint loaders set (models/loader.py,
llm/gguf.py) keep the JAX meanings and defaults: q/k/v bias (Qwen2), the
Gemma deltas (embedding scale, (1 + w) norms, tanh-GELU) and the Gemma-2
post norms, final soft-cap, attention soft-cap, sliding windows
(`sliding_window`, `sliding_pattern`, `layer_windows`) and query scale.

`decode_kernel` picks the decode attention path as in JAX ("auto", "on",
"off", "interpret"); the engine resolves it once, at build, with
models/llama.decode_path. Unlike JAX, whose "auto" is the gather window
everywhere, the port's "auto" (and "on", "interpret") is the ragged kernel
wherever it serves the config; the attention knobs, and head dims or GQA
groups the kernel cannot take, resolve to the gather window, with the
reason named. `check_supported` refuses what neither path serves: on a
CUDA device dtypes other than f32 and bf16, and an MoE dispatch gated by
anything but SiLU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for a decoder-only transformer."""

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
    attn_bias: bool = False      # q/k/v projection bias (Qwen2-style)
    # Gemma-family architecture deltas (HF GemmaForCausalLM):
    embed_scale: float = 0.0     # 0 = off; Gemma multiplies embeddings by
    #                              sqrt(hidden_size) before the first layer
    norm_plus_one: bool = False  # RMSNorm weight applied as (1 + w), in f32
    mlp_act: str = "silu"        # "silu" | "gelu_tanh" (Gemma GeGLU)
    # Gemma-2 deltas:
    post_norms: bool = False     # extra post-attention / post-ffw RMSNorms
    final_softcap: float = 0.0   # tanh soft-cap on lm-head logits (30.0)
    attn_softcap: float = 0.0    # tanh soft-cap on attention logits (50.0)
    query_scale: float = 0.0     # q scaling; 0 = default head_dim**-0.5
    #                              (Gemma-2 uses query_pre_attn_scalar**-0.5)
    sliding_window: int = 0      # sliding-window attention width; 0 = full
    # which layers use the sliding window (only meaningful when
    # sliding_window > 0): "alternate" = even layers sliding, odd global
    # (the Gemma-2 pattern); "all" = every layer sliding
    sliding_pattern: str = "alternate"
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
    # MoE (Mixtral-style); num_experts == 0 means dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # "dispatch" = capacity-based dispatch (ops/moe.py, serving default);
    # "dense" = every expert computes every token (exact, E/k x FLOPs —
    # oracle for tests)
    moe_impl: str = "dispatch"
    moe_capacity_factor: float = 2.0
    # decode attention path: "auto", "on" and "interpret" = the ragged
    # kernel (its plain version on CPU tensors) wherever it serves the
    # config, else the gather window; "off" = the gather window
    # (models/llama.decode_path)
    decode_kernel: str = "auto"
    # multimodal: the vision tower whose projected patch embeds replace the
    # token embeds at image positions (models/vision.py); None = text-only
    vision: Optional["VisionConfig"] = None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_windows(self):
        """Per-layer attention window as an int list: the sliding width
        for sliding layers, a huge sentinel (2**30, effectively full) for
        global layers. None when every layer is full-attention."""
        if not self.sliding_window:
            return None
        full = 1 << 30
        if self.sliding_pattern == "all":
            return [self.sliding_window] * self.num_layers
        # Gemma-2: even layers sliding, odd layers global
        return [self.sliding_window if l % 2 == 0 else full
                for l in range(self.num_layers)]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision encoder config (ViT-style) for multimodal models; the tower
    projects hidden_size into the text model's hidden size."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 128
    intermediate_size: int = 256
    num_layers: int = 2
    num_heads: int = 4


MOE_IMPLS = ("dispatch", "dense")
MLP_ACTS = ("silu", "gelu_tanh")
DECODE_KERNEL_MODES = ("auto", "on", "off", "interpret")
SLIDING_PATTERNS = ("alternate", "all")
# the model dtypes the port's CUDA kernels take
CUDA_DTYPES = ("float32", "bfloat16")


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for configs the port cannot serve, and
    ValueError for inconsistent ones. With a CUDA `device` (the engine's)
    a model dtype the kernels cannot take is refused too; on the CPU the
    kernels' plain versions serve any. Head dims and GQA groups the ragged
    kernel cannot take are no refusal: they decode through the gather
    window (models/llama.decode_path)."""
    if cfg.decode_kernel not in DECODE_KERNEL_MODES:
        raise ValueError(f"unknown decode_kernel {cfg.decode_kernel!r} "
                         f"(supported: {', '.join(DECODE_KERNEL_MODES)})")
    if cfg.sliding_pattern not in SLIDING_PATTERNS:
        raise ValueError(f"unknown sliding_pattern {cfg.sliding_pattern!r} "
                         f"(supported: {', '.join(SLIDING_PATTERNS)})")
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r} (supported: "
                         f"{', '.join(MOE_IMPLS)})")
    if cfg.mlp_act not in MLP_ACTS:
        raise ValueError(f"unknown mlp_act {cfg.mlp_act!r} (supported: "
                         f"{', '.join(MLP_ACTS)})")
    if cfg.is_moe and cfg.mlp_act != "silu" and cfg.moe_impl == "dispatch":
        # the JAX dispatch gates its experts with SiLU whatever mlp_act is
        raise NotImplementedError(
            f"model {cfg.name!r}: the MoE dispatch gates with SiLU only, "
            f"not {cfg.mlp_act!r}")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_heads {cfg.num_heads} is not a multiple of "
                         f"num_kv_heads {cfg.num_kv_heads}")
    if device is None or not str(device).startswith("cuda"):
        return
    if cfg.dtype not in CUDA_DTYPES:
        raise NotImplementedError(
            f"model {cfg.name!r} in dtype {cfg.dtype} cannot run on CUDA: "
            f"the port's kernels take {', '.join(CUDA_DTYPES)}")


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
    # decode-time KV streaming past the HBM page budget (engine/
    # streaming.py): a request whose admission-time page count exceeds
    # stream_resident_pages keeps that many pages resident and attends the
    # rest from the host tier through a double-buffered window pool of
    # stream_pages slots a half (0 = streaming off; requires host_pages >
    # 0). The first stream_hot_pages logical pages are never spilled.
    stream_pages: int = 0
    stream_resident_pages: int = 8
    stream_hot_pages: int = 2
    # the tensor-parallel mesh axis's size (parallel/): the engine of a
    # group of tp ranks checks it against its mesh; run.py --tp spawns the
    # ranks
    tp: int = 1
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
    # speculative decoding ("" = off; "ngram" = prompt-lookup drafts;
    # "draft" = a small draft model proposes, engine/spec.py): greedy plans
    # verify up to spec_k draft tokens in one target forward, and the
    # output is token for token the plain greedy output (exact in f32; in
    # bf16 the verify and the window sum in other orders). Sampled,
    # logprob and penalty plans take the decode window; a spec engine
    # never pipelines.
    spec_decode: str = ""
    spec_k: int = 4                     # draft tokens verified per forward
    # "draft" mode: a registry name (random weights from the engine seed)
    # or an HF checkpoint directory; its vocabulary must be the target's
    spec_draft_model: str = ""
    # the cost gate (engine._spec_worthwhile; its terms and the n-gram
    # lengths are engine/spec.py's constants) refuses drafts that would not
    # beat the window; every spec_probe_every-th refusal forces a probe
    # that refreshes the acceptance ema
    spec_probe_every: int = 32


# -- named architectures ------------------------------------------------------

_CONFIGS = {
    # test-size models
    "tiny": ModelConfig(),
    "tiny-moe": ModelConfig(
        name="tiny-moe", num_experts=4, num_experts_per_tok=2,
        intermediate_size=256,
    ),
    "tiny-vl": ModelConfig(
        name="tiny-vl", dtype="float32",
        vision=VisionConfig(image_size=28, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2)),
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
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=1e6, max_model_len=16384,
        num_experts=8, num_experts_per_tok=2,
    ),
    "qwen2-vl-7b": ModelConfig(
        name="qwen2-vl-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1e6, max_model_len=16384,
        vision=VisionConfig(image_size=448, patch_size=14, hidden_size=1280,
                            intermediate_size=3420, num_layers=32,
                            num_heads=16),
    ),
}


def get_model_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown model config {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]
