"""The tensor-parallel mesh of one engine: axis conventions and its group.

Port of dynamo_tpu/parallel/mesh.py. The JAX package builds one `Mesh`
over a device array and lets XLA lay collectives over it; here each rank is
a process of its own (one card, or the CPU), so a `Mesh` is this process's
view of the mesh: the axis sizes (`shape`, the JAX mesh's `mesh.shape`),
this process's rank on "tp", its device and the process group the ranks'
collectives run on (parallel/comm.TpComm). The axis names and their order
are JAX's (`AXES`); the slice of the port that this file serves runs "tp"
only, and an engine refuses a mesh with any other axis above 1 by name.

`shard_map_compat` has no counterpart: each rank calls its own kernels on
its own shard of the heads, so nothing needs mapping over the mesh.
`kv_shard_layout` is a copy (pure Python): the disaggregated transfer's
slice plan over the cache's (layer, kv-head) axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

AXES = ("dp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass
class Mesh:
    """One process's place on the mesh: the axis sizes, its rank on "tp",
    its device and the group its tensor-parallel collectives run on (None:
    an engine that holds no group, as `run.py --tp 1` builds)."""

    shape: Dict[str, int]
    rank: int = 0
    device: Any = "cpu"
    comm: Optional[Any] = None     # parallel/comm.TpComm

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)


def make_mesh(dp: int = 1, tp: int = 1, pp: int = 1, ep: int = 1,
              sp: int = 1, rank: int = 0, device="cpu",
              comm=None) -> Mesh:
    """A Mesh with the framework's canonical axes (JAX `make_mesh`): every
    size >= 1 and the rank within "tp". The group that spans the ranks is
    `comm` (parallel/launch.py builds it); a mesh without one describes a
    layout, as the shard functions of models/llama.py take it."""
    sizes = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
    for axis, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {axis!r} needs a size >= 1, got {n}")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} is outside tp={tp}")
    if comm is not None and comm.size != tp:
        raise ValueError(f"the group holds {comm.size} ranks, the mesh's tp "
                         f"axis {tp}")
    return Mesh({axis: sizes[axis] for axis in AXES}, rank,
                torch.device(device), comm)


def single_device_mesh(device="cpu") -> Mesh:
    return make_mesh(device=device)


def kv_shard_layout(num_layers: int, num_kv_heads: int, tp: int = 1,
                    pp: int = 1, n_streams: int = 0) -> list:
    """Slice plan for sharded parallel KV transfer (disagg data plane).

    Returns one entry per transfer stream, each a tuple of
    ``(axis, start, count)`` slices over the paged-cache leaf layout
    ([L, Hkv, P, ps, hd] values; [L, Hkv, P, ps] kv_quant scales —
    axes 0 and 1 are shared, so one plan slices both): the KV sharding
    spec of this mesh (models/llama.cache_sharding: heads over "tp";
    models/pp.pp_cache_sharding: layers over "pp" too) cut into the
    per-shard blocks that land on distinct device groups. A sender
    that ships each slice on its own stream to the host owning that
    shard is the multi-NIC parallel placement the disagg data plane
    needs — no stream ever carries bytes two hosts both store.

    `n_streams` (non-pp only) overrides the natural tp count, further
    subdividing (or merging) the kv-head axis — the CPU-validation
    knob for A/Bing stream counts independent of mesh shape; it must
    divide num_kv_heads. 0/1 natural slicing; the degenerate 1-stream
    plan is a single full-cache slice (the legacy single-stream wire
    format stays byte-identical in that case)."""
    if pp > 1:
        if n_streams:
            raise ValueError("n_streams override requires pp == 1 "
                             "(pp slices the layer axis per stage)")
        if num_layers % pp or num_kv_heads % tp:
            raise ValueError(
                f"kv shard layout needs pp|L and tp|Hkv, got L={num_layers} "
                f"pp={pp} Hkv={num_kv_heads} tp={tp}")
        lc, hc = num_layers // pp, num_kv_heads // tp
        return [((0, s * lc, lc), (1, h * hc, hc))
                for s in range(pp) for h in range(tp)]
    n = n_streams or tp
    if n <= 1:
        return [((1, 0, num_kv_heads),)]
    if num_kv_heads % n:
        raise ValueError(
            f"{n} transfer streams must divide num_kv_heads "
            f"({num_kv_heads})")
    hc = num_kv_heads // n
    return [((1, h * hc, hc),) for h in range(n)]
