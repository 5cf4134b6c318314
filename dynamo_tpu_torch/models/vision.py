"""ViT vision encoder for multimodal (Qwen2-VL-class) serving.

Port of dynamo_tpu/models/vision.py: `num_patches`, `init_params`,
`patchify` and `encode` as functions on tensors over a plain dict of
parameters stacked over layers, with the JAX package's names and layouts
(models/llama.py's idiom), so `params_from_jax` moves the tree as it is.
The layer `lax.scan` becomes a Python loop over layer slices. The tower's
sharding specs (`param_shardings`) stay with multi-device serving.

The arithmetic is the JAX function's, op for op and dtype for dtype, so
the rounding is the reference's:
- pixels are cast to the model dtype before patchify, a reshape plus one
  [P*P*3, D] product (a non-overlapping conv patch embed);
- `_layer_norm` has no bias and eps 1e-6: it normalises in f32, casts to
  the activations' dtype, and only then multiplies by its weight;
- attention is full (non-causal) over the patches, plain products in
  JAX's order and not a library attention kernel: the scores come out of
  the product in the model dtype and are widened to f32, softmax(scores *
  hd^-0.5) runs in f32 and is cast back for P.V;
- the MLP is up, tanh-GELU in f32 (`jax.nn.gelu` defaults to
  approximate=True), down;
- a final norm and the projection into the text model's embedding space,
  so the engine receives [n_patches, D_text] rows ready to mix into the
  text prefill (models/llama.forward `input_embeds` / `embeds_mask`).

The products are `torch.matmul`, as every product XLA computes outside
Pallas: the JAX tower has no Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import ModelConfig, VisionConfig
from dynamo_tpu_torch.models.llama import torch_dtype

Params = Dict[str, Any]

# the tower's norm weights: ones at init, not draws
_NORM_KEYS = ("attn_norm", "mlp_norm")


def num_patches(vcfg: VisionConfig) -> int:
    side = vcfg.image_size // vcfg.patch_size
    return side * side


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The tower's parameter tree as shapes (the JAX init_params layout):
    {"patch_embed", "pos_embed", "layers": {...}, "final_norm", "proj"}."""
    vcfg = cfg.vision
    d, f, h = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_heads
    hd = d // h
    n = vcfg.num_layers
    patch_dim = vcfg.patch_size * vcfg.patch_size * 3
    return {
        "patch_embed": (patch_dim, d),
        "pos_embed": (num_patches(vcfg), d),
        "layers": {
            "attn_norm": (n, d),
            "wq": (n, d, h * hd),
            "wk": (n, d, h * hd),
            "wv": (n, d, h * hd),
            "wo": (n, h * hd, d),
            "mlp_norm": (n, d),
            "w_up": (n, d, f),
            "w_down": (n, f, d),
        },
        "final_norm": (d,),
        "proj": (d, cfg.hidden_size),
    }


def init_params(cfg: ModelConfig, device="cuda",
                generator: torch.Generator = None) -> Params:
    """Random-init tower parameters (stacked over layers) in the text
    model's dtype, drawn on `device` from `generator`: dense weights
    N(0, 1/fan_in) and norms ones, the JAX recipe (the values differ from
    its jax.random draws; tests hand both packages the same weights through
    llama.params_from_jax)."""
    dt = torch_dtype(cfg)
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    shapes = param_shapes(cfg)

    def dense(shape, fan_in=None):
        """fan_in defaults to the product's contraction dim (shape[-2])."""
        w = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return w.mul_((fan_in or shape[-2]) ** -0.5)

    layers = {}
    for key, shape in shapes["layers"].items():
        if key in _NORM_KEYS:
            layers[key] = torch.ones(shape, dtype=dt, device=device)
        else:
            layers[key] = dense(shape)
    return {
        "patch_embed": dense(shapes["patch_embed"]),
        "pos_embed": dense(shapes["pos_embed"], cfg.vision.hidden_size),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=dt,
                                 device=device),
        "proj": dense(shapes["proj"]),
    }


def _layer_norm(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, patch*patch*3] (row-major patches)."""
    b, hh, ww, c = pixels.shape
    gh, gw = hh // patch, ww // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)          # [B, gh, gw, p, p, C]
    return x.reshape(b, gh * gw, patch * patch * c)


def encode(params: Params, cfg: ModelConfig,
           pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] float in [0, 1] -> embeds [B, n_patches, D_text]
    in the model dtype. H and W must equal vision.image_size (the
    preprocessor resizes on the host)."""
    vcfg = cfg.vision
    d, h = vcfg.hidden_size, vcfg.num_heads
    hd = d // h
    dt = torch_dtype(cfg)
    lp = params["layers"]

    x = patchify(pixels.to(dt), vcfg.patch_size)
    x = torch.matmul(x, params["patch_embed"])
    x = x + params["pos_embed"][None]
    b, n, _ = x.shape
    for l in range(vcfg.num_layers):
        xn = _layer_norm(x, lp["attn_norm"][l])
        # [B, H, n, hd]
        q, k, v = (torch.matmul(xn, lp[key][l]).reshape(b, n, h, hd)
                   .transpose(1, 2) for key in ("wq", "wk", "wv"))
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        attn = torch.softmax(scores * hd ** -0.5, dim=-1).to(x.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * hd)
        x = x + torch.matmul(o, lp["wo"][l])
        xn = _layer_norm(x, lp["mlp_norm"][l])
        up = torch.matmul(xn, lp["w_up"][l])
        act = F.gelu(up.float(), approximate="tanh").to(x.dtype)
        x = x + torch.matmul(act, lp["w_down"][l])
    x = _layer_norm(x, params["final_norm"])
    return torch.matmul(x, params["proj"])
