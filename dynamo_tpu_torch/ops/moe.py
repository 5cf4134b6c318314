"""Mixture-of-experts dispatch: top-k routing with a fixed expert capacity.

Port of dynamo_tpu/ops/moe.py:32-114 (`moe_dispatch_mlp`, `_route`) on one
device; the expert-parallel `moe_dispatch_mlp_sharded` waits for the
port's multi-device slice. The function is the JAX one's:
- the router logits in f32, the top k of them with ties broken toward the
  lower expert index (`jax.lax.top_k`'s rule, written out in `top_k`
  because `torch.topk` does not promise it), a softmax over the k chosen
  logits in f32;
- the (token, choice) pairs flattened token-major, each pair's position in
  its expert's buffer the running count of earlier pairs routed there
  (a cumsum over the flat axis), per batch row;
- a capacity of max(int(T * k / E * capacity_factor), 1) positions per
  expert and batch row: a pair at or past it is dropped (GShard);
- `valid` [B, T] masks padding: a masked token routes nowhere, takes no
  capacity and counts in neither counter;
- the output is the sum over the k choices, in f32, of each kept choice's
  weight times its expert's output, cast to x's dtype; with
  return_dropped also (dropped, routed) pair counts as f32 scalars.

The JAX function builds the dispatch and combine as one-hot tensors
[B, T * k, E, C] and contracts them with einsums; at a 512-token chunk of 8
rows that one-hot is ~67 MB of f32. Here the capacity buffer is filled and
read back by index: each kept pair copies its token into its (expert,
position) row, and each pair reads its expert's output from that row. The
values are the einsum form's: its contractions have one non-zero term per
output (exact zeros elsewhere), so the buffer holds x exactly and each
choice contributes w * y in f32 before the k-sum.

The buffer is laid out expert-major, [E, B * C, D], so each expert's rows
are one contiguous block: the expert products (`ops/quant.grouped_linear`)
see M = B * C rows an expert, 8 at a decode step of 8 slots (C = 1 there).
`active[e]`, the pairs kept for expert e, tells the grouped W8A16 kernel
which experts to skip; it is computed on the device, so a decode window
stays one captured CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops.quant import grouped_linear


def top_k(logits: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries along the last axis, in
    descending order, ties broken toward the lower index (as
    `jax.lax.top_k`). An entry's rank is the number of entries above it
    plus the number of equal ones before it; the entry of rank j is the
    j-th choice. O(E^2) compares a token, nothing data-dependent on the
    host."""
    e = logits.shape[-1]
    a = logits.unsqueeze(-1)            # [..., E, 1]: the entry
    b = logits.unsqueeze(-2)            # [..., 1, E]: the others
    lower = torch.ones((e, e), dtype=torch.bool,
                       device=logits.device).tril(-1)   # [i, j]: j < i
    rank = ((b > a) | ((b == a) & lower)).sum(-1)       # [..., E]
    choice = torch.arange(k, device=logits.device)
    idx = (rank.unsqueeze(-2) == choice[:, None]).int().argmax(-1)
    return logits.gather(-1, idx), idx


def route(x: torch.Tensor, router: torch.Tensor, e: int, k: int,
          capacity_factor: float, valid=None) -> dict:
    """The routing of `moe_dispatch_mlp` (JAX `_route`): x [B, T, D],
    router [D, E]. Returns idx / weights [B, T * k] (the flat pairs'
    experts and softmax weights, f32), pos [B, T * k] (each pair's
    position in its expert's buffer), keep [B, T * k] bool, active [E]
    int32 (pairs kept per expert), cap, and the f32 counters routed and
    dropped."""
    b, t, _ = x.shape
    logits = x.float() @ router.float()                  # [B, T, E]
    weights, idx = top_k(logits, k)
    weights = torch.softmax(weights, dim=-1)
    sel = F.one_hot(idx, e).float()                      # [B, T, k, E]
    if valid is not None:
        sel = sel * valid.float()[:, :, None, None]
    sel_flat = sel.reshape(b, t * k, e)
    pos = torch.cumsum(sel_flat, dim=1) - 1.0            # [B, S, E]
    cap = max(int(t * k / e * capacity_factor), 1)
    keep = (pos < cap) * sel_flat                        # [B, S, E]
    idx_flat = idx.reshape(b, t * k, 1)
    routed = sel_flat.sum()
    return {"idx": idx_flat[..., 0],
            "weights": weights.reshape(b, t * k),
            "pos": pos.gather(-1, idx_flat)[..., 0].long(),
            "keep": keep.gather(-1, idx_flat)[..., 0] > 0,
            "active": keep.sum(dim=(0, 1)).int(),
            "cap": cap, "routed": routed, "dropped": routed - keep.sum()}


def dispatch(x: torch.Tensor, r: dict, e: int, k: int) -> tuple:
    """The capacity buffer [E, B * C, D] of x [B, T, D] under routing r
    (each token repeated k times, token-major, as the flat pairs), and each
    flat pair's row in it ([B, T * k]; meaningful for kept pairs only).
    Unfilled rows are zeros."""
    b, t, d = x.shape
    cap = r["cap"]
    rows = (r["idx"] * (b * cap)
            + torch.arange(b, device=x.device)[:, None] * cap
            + r["pos"].clamp(0, cap - 1))
    # dropped pairs (and masked ones) write into one extra row, cut below
    dst = torch.where(r["keep"], rows, e * b * cap).reshape(-1)
    src = x.reshape(b * t, 1, d).expand(b * t, k, d).reshape(-1, d)
    buf = torch.zeros((e * b * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dst, src)
    return buf[:-1].view(e, b * cap, d), rows


def moe_dispatch_mlp(x: torch.Tensor, lp: dict, cfg,
                     capacity_factor: float = 2.0,
                     return_dropped: bool = False, valid=None):
    """Top-k routed expert MLP with fixed-capacity dispatch.

    x [B, T, D]; lp holds one layer's router [D, E] and expert weights
    w_gate / w_up [E, D, F], w_down [E, F, D] (plain, or {"q", "s"} int8
    with scales [E, 1, F] / [E, 1, D]). Returns [B, T, D], or ([B, T, D],
    (dropped, routed)) with return_dropped. valid: optional [B, T] mask of
    real (non-padding) positions."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    r = route(x, lp["router"], e, k, capacity_factor, valid)
    xin, rows = dispatch(x, r, e, k)
    active = r["active"]
    gate = grouped_linear(xin, lp["w_gate"], active)
    up = grouped_linear(xin, lp["w_up"], active)
    act = F.silu(gate.float()).to(x.dtype) * up
    y = grouped_linear(act, lp["w_down"], active)        # [E, B * C, D]
    # each pair reads its own row back: w * y in f32, 0 where not kept
    got = y.reshape(-1, d)[rows.reshape(-1)].float().view(b, t * k, d)
    part = torch.where(r["keep"][..., None], r["weights"][..., None] * got,
                       0.0)
    out = part.view(b, t, k, d).sum(dim=2).to(x.dtype)
    if return_dropped:
        return out, (r["dropped"], r["routed"])
    return out
