"""Multi-process bootstrap of one tensor-parallel engine.

Port of dynamo_tpu/parallel/bootstrap.py. The JAX package joins every
process of an engine to a `jax.distributed` coordinator, after which one
mesh spans them; here every rank is a process that joins one
`torch.distributed` process group over TCP, with an explicit backend:
NCCL for CUDA ranks, gloo for CPU ranks, or the `backend` argument, which
overrides both (gloo on CUDA tensors runs a group whose ranks share a card,
where NCCL refuses two ranks on one device).

Config comes from the arguments or the environment (the JAX names):
- DYN_COORD_ADDR   e.g. "127.0.0.1:29500" — absent => single-process (no-op)
- DYN_NUM_PROCESSES
- DYN_PROCESS_ID

Every process of a multi-process engine runs in lockstep: rank 0 owns the
scheduler and the page allocator, and before each device launch it
broadcasts the launch's inputs, which the other ranks run as they come
(engine/engine.py `follow`); the collectives inside the model line up
because every rank runs the same launches in the same order.

`python -m dynamo_tpu_torch.parallel.bootstrap --selftest-child ...` is the
child entry of the JAX package's 2-process dry run, as one rank a process
on the CPU: it joins the coordinator, builds a tp mesh over the ranks and
runs one full engine generate over it (the `mp-dry` config, 8 / 4 heads of
32), printing the JAX line `MPDRY process=... devices=... mesh=dp1xtpN
tokens=[...]` on every rank.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.parallel")

# a follower waits on the control group between rank 0's launches however
# long rank 0 idles (a server with no traffic); a peer that dies closes
# its sockets, which ends the wait at once
CONTROL_TIMEOUT = datetime.timedelta(days=7)


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if str(device).startswith("cuda") else "gloo"


def bootstrap_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cpu",
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join this process to the engine's process group.

    Arguments default to the DYN_COORD_ADDR / DYN_NUM_PROCESSES /
    DYN_PROCESS_ID env vars. Returns True when the group was initialized,
    False for the single-process no-op. `device` is this rank's device
    (the backend follows it unless `backend` is given); `timeout_s` bounds
    each collective of the default group."""
    coordinator = coordinator or os.environ.get("DYN_COORD_ADDR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("DYN_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("DYN_PROCESS_ID", "-1"))
    if num_processes <= 0 or process_id < 0:
        raise ValueError(
            "multi-process bootstrap needs num_processes > 0 and "
            f"process_id >= 0 (got {num_processes}, {process_id})")
    import torch
    import torch.distributed as dist
    backend = backend or default_backend(device)
    kw = {}
    if backend == "nccl":
        # binds the communicator to this rank's card at once
        kw["device_id"] = torch.device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    log.info("joined process group: coordinator=%s rank %d/%d backend %s "
             "device %s", coordinator, process_id, num_processes, backend,
             device)
    return True


def world_comm(device, backend: Optional[str] = None):
    """The TpComm of this rank over the whole (initialized) group, with its
    host-side control group; on NCCL a first all-reduce sets up the
    communicator, so no CUDA graph capture is the first to touch it."""
    import torch
    import torch.distributed as dist
    from dynamo_tpu_torch.parallel.comm import TpComm
    backend = backend or dist.get_backend()
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    comm = TpComm(dist.get_rank(), dist.get_world_size(), backend, device,
                  control=control)
    warm = torch.zeros(1, device=device)
    dist.all_reduce(warm)
    if warm.is_cuda:
        torch.cuda.synchronize(warm.device)
    return comm


def shutdown() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _selftest_child(coordinator: str, num_processes: int,
                    process_id: int) -> None:
    """Dry-run child: full engine generate over a multi-process CPU mesh."""
    bootstrap_distributed(coordinator, num_processes, process_id,
                          device="cpu")
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.engine.scheduler import SamplingParams
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    comm = world_comm("cpu")
    tp = comm.size
    mesh = make_mesh(tp=tp, rank=comm.rank, device="cpu", comm=comm)
    cfg = ModelConfig(name="mp-dry", vocab_size=256, hidden_size=128,
                      intermediate_size=256, num_layers=2, num_heads=8,
                      num_kv_heads=4, head_dim=32, max_model_len=256)
    eng_cfg = EngineConfig(page_size=8, num_pages=32, max_slots=4,
                           max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                           max_model_len=256, tp=tp)
    engine = NativeEngine(cfg, eng_cfg, mesh=mesh, seed=0, device="cpu")
    out = None
    if comm.rank == 0:
        out = engine.generate(list(range(20)), SamplingParams(max_tokens=4),
                              "mp-dry")
        engine.close()
    else:
        engine.follow()
    out = comm.broadcast(out)
    print(f"MPDRY process={process_id} devices={tp} mesh=dp1xtp{tp} "
          f"tokens={out}", flush=True)
    shutdown()


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--selftest-child", action="store_true")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    args = p.parse_args()
    if args.selftest_child:
        _selftest_child(args.coordinator, args.num_processes,
                        args.process_id)
    else:
        bootstrap_distributed(args.coordinator, args.num_processes,
                              args.process_id)


if __name__ == "__main__":
    main()
