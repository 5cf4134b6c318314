"""The collectives of one tensor-parallel rank (`TpComm`).

The JAX package leaves tensor parallelism to XLA: the params carry
PartitionSpecs over the mesh axis "tp" (dynamo_tpu/models/llama.py:161-238)
and XLA inserts a psum after `wo` and after `w_down`, and gathers the
vocab-sharded logits where a replicated value is needed. Here each rank is
a process and the model calls those collectives itself, through this
object, on the group `parallel/launch.py` builds:

- `reduce_product`: a row-sharded product (`wo`, `w_down`) summed over
  the ranks, the psum. With more than one rank each partial product is
  taken in f32 and all-reduced in f32, and the sum rounded once to the
  activations' dtype, as the unsharded product rounds once (bf16 partial
  sums added in bf16 would round four times over at tp 4); a group of one
  all-reduces the product as the unsharded engine computes it. NCCL on
  the card, gloo on the CPU or when asked for;
- `gather_vocab`: each rank's slice of the logits written into a zeroed
  full-vocab f32 buffer and all-reduced. gloo has no all-gather of CUDA
  tensors (only broadcast and all-reduce), and adding zeros is exact, so
  every rank ends with the same logits bytes on either backend;
- `check_tokens`: after sampling, one all-reduce (MAX) of [tokens,
  -tokens]; a rank whose tokens differ from another's counts a mismatch on
  the device (`mismatches`), and a digest of every token the rank sampled
  (`digest`) lets a reader compare the ranks without a collective.

Each all-reduce (`reduce_product`, `gather_vocab`, `check_tokens`) counts one
collective: `ALL_REDUCES` when it runs, `ALL_REDUCES_CAPTURED` when a CUDA
graph captures it (engine/window_graph.py adds a graph's captured calls to
`ALL_REDUCES` at each replay, as it does for the kernels).

The control messages of the lockstep (rank 0's step inputs, the stats a
follower reports) cross a second group, gloo on the host (`broadcast`,
`gather`): they are Python objects, and a follower waits there between
steps however long rank 0 idles.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

ALL_REDUCES = 0
ALL_REDUCES_CAPTURED = 0

# the token digest's modulus (a prime below 2**31: the products stay in
# int64)
_DIGEST_MOD = 2 ** 31 - 1


def vocab_range(vocab: int, rank: int, tp: int) -> tuple:
    """[start, end) of rank's slice of a vocab-sharded lm_head: ceil(V /
    tp) columns a rank, the last rank's shorter when tp does not divide V
    (JAX's P(None, "tp") slices when it does)."""
    step = -(-vocab // tp)
    start = min(vocab, rank * step)
    return start, min(vocab, start + step)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class TpComm:
    """One rank's view of its tensor-parallel group."""

    def __init__(self, rank: int, size: int, backend: str, device,
                 control=None):
        self.rank = rank
        self.size = size
        self.backend = backend      # the default group's: every rank's
        self.device = torch.device(device)
        self.control = control      # the host-side gloo group
        # tokens this rank sampled that another rank did not, and a digest
        # of every token it sampled (device scalars: no sync per step)
        self.mismatches = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.digest = torch.zeros((), dtype=torch.int64, device=self.device)

    def _reduce(self, x: torch.Tensor, op=None) -> None:
        import torch.distributed as dist
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM)

    def _count(self, x: torch.Tensor) -> None:
        global ALL_REDUCES, ALL_REDUCES_CAPTURED
        if _capturing(x):
            ALL_REDUCES_CAPTURED += 1
        else:
            ALL_REDUCES += 1

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the ranks in place; returns x."""
        self._reduce(x)
        self._count(x)
        return x

    def reduce_product(self, x: torch.Tensor, w: torch.Tensor
                       ) -> torch.Tensor:
        """x [..., K_r] @ w [K_r, N] (this rank's rows of a row-sharded
        weight) summed over the ranks, in x's dtype (see the module
        docstring)."""
        if self.size == 1:
            return self.all_reduce(x @ w)
        x2 = x.reshape(-1, x.shape[-1])
        if x2.dtype == torch.float32:
            y = x2 @ w
        elif x2.is_cuda:
            # cuBLAS accumulates the bf16 operands in f32 and writes f32
            y = torch.bmm(x2[None], w[None], out_dtype=torch.float32)[0]
        else:
            y = x2.float() @ w.float()
        return self.all_reduce(y).to(x.dtype).reshape(
            *x.shape[:-1], w.shape[-1])

    def gather_vocab(self, local: torch.Tensor, vocab: int) -> torch.Tensor:
        """[..., V_r] logits of this rank's vocab slice -> [..., V] f32 on
        every rank, bit-equal across ranks."""
        start, end = vocab_range(vocab, self.rank, self.size)
        full = torch.zeros(local.shape[:-1] + (vocab,), dtype=torch.float32,
                           device=local.device)
        full[..., start:end] = local
        self._reduce(full)
        self._count(full)
        return full

    def check_tokens(self, toks: torch.Tensor) -> None:
        """Count a mismatch when any rank sampled other tokens than this
        one (max over the ranks of [toks, -toks] equals [toks, -toks] only
        if every rank holds toks), and fold toks into the digest."""
        import torch.distributed as dist
        t = toks.reshape(-1).to(torch.int64)
        both = torch.stack([t, -t])
        self._reduce(both, dist.ReduceOp.MAX)
        self._count(both)
        self.mismatches += ((both[0] != t) | (both[1] != -t)).any()
        weights = torch.arange(1, t.numel() + 1, dtype=torch.int64,
                               device=t.device)
        self.digest.mul_(1000003).add_((t * weights).sum()).remainder_(
            _DIGEST_MOD)

    # -- the control group (host objects) ------------------------------------

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0's `obj`, on every rank (rank 0 passes it, the others
        receive it)."""
        import torch.distributed as dist
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def gather(self, obj: Any) -> Optional[list]:
        """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
        import torch.distributed as dist
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        return out

    def token_stats(self) -> dict:
        """This rank's mismatch count and token digest (a device sync)."""
        return {"token_mismatches": int(self.mismatches),
                "token_digest": int(self.digest)}
