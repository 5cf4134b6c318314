"""The ranks of a tensor-parallel engine as processes.

The JAX package serves a model over a mesh from one program
(dynamo_tpu/run.py:92-98); here a tp engine is one process a rank. The
calling process is rank 0: `tp_engine` picks a free port, builds the CUDA
kernels once (N ranks on a fresh build directory would each run nvcc),
starts ranks 1..N-1 as `python -m dynamo_tpu_torch.parallel.launch
--follower SPEC` processes (the DYN_COORD_ADDR / DYN_NUM_PROCESSES /
DYN_PROCESS_ID environment of parallel/bootstrap.py), joins the group and
yields its own engine, whose `step()` drives every rank; each follower
builds its shard of the same engine and runs `engine.follow()` until rank
0 closes. A follower dies with its parent (PR_SET_PDEATHSIG), and the
launcher ends every rank it started.

Placement (`rank_devices`): on "cuda" rank r runs on cuda:r over NCCL, and
fewer visible cards than ranks is refused with both counts; on "cpu" every
rank runs on the CPU over gloo. `backend` and `devices` override that:
`backend="gloo", devices=["cuda:0"] * 4` runs four ranks on one card (gloo
copies each collective through the host); NCCL never takes two ranks on
one device, and nothing switches the backend by itself.

Weights: random from the seed (each rank its shard of the same draws,
models/llama.init_params), a JAX-layout tree saved with `save_tree`
(numpy .npz; each rank cuts its shard with params_from_jax), or a
checkpoint directory or .gguf file (read whole on the host by each rank,
then cut: the per-rank read of a checkpoint is not ported yet).
"""
from __future__ import annotations

import base64
import contextlib
import ctypes
import dataclasses
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.parallel.bootstrap import (
    bootstrap_distributed, default_backend, shutdown, world_comm,
)

_REPO = str(Path(__file__).resolve().parents[2])


@dataclasses.dataclass
class RankSpec:
    """What every rank needs to build its part of the engine."""

    model_cfg: ModelConfig
    engine_cfg: EngineConfig
    devices: list
    backend: str
    port: int
    seed: int = 0
    eos_token_ids: Optional[list] = None
    weights_npz: Optional[str] = None
    checkpoint: Optional[str] = None
    timeout_s: float = 600.0

    @property
    def tp(self) -> int:
        return self.engine_cfg.tp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(tp: int, device: str = "cuda",
                 backend: Optional[str] = None,
                 devices: Optional[Sequence] = None) -> tuple:
    """(each rank's device, the backend) for `tp` ranks (see the module
    docstring); raises ValueError for a placement it will not make."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is not None:
        devices = [str(d) for d in devices]
        if len(devices) != tp:
            raise ValueError(f"{len(devices)} devices given for tp={tp}")
    elif str(device).startswith("cuda"):
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise ValueError(f"tp={tp} needs {tp} CUDA devices, {n} visible "
                             "(one rank a card; pass device='cpu' for CPU "
                             "ranks)")
        devices = [f"cuda:{r}" for r in range(tp)]
    else:
        devices = ["cpu"] * tp
    backend = backend or default_backend(devices[0])
    if backend == "nccl":
        if not all(d.startswith("cuda") for d in devices):
            raise ValueError(f"NCCL ranks run on CUDA devices, got {devices}")
        if len(set(devices)) < tp:
            raise ValueError(f"NCCL refuses two ranks on one device "
                             f"({devices}); use backend='gloo' to share a "
                             "card")
    return devices, backend


def save_tree(path: str, tree: dict) -> None:
    """A parameter tree of numpy-convertible leaves as one .npz ('layers/wq'
    keys)."""
    flat = {}

    def walk(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = np.asarray(v, np.float32)
    walk("", tree)
    np.savez(path, **flat)


def load_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def build_rank_engine(spec: RankSpec, rank: int, comm):
    """This rank's NativeEngine on its device, its shard of the weights."""
    from dynamo_tpu_torch.engine.engine import NativeEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.parallel.mesh import make_mesh
    device = spec.devices[rank]
    mesh = make_mesh(tp=spec.tp, rank=rank, device=device, comm=comm)
    params = None
    if spec.weights_npz:
        params = llama.params_from_jax(load_tree(spec.weights_npz),
                                       spec.model_cfg, device, mesh=mesh)
    elif spec.checkpoint:
        from dynamo_tpu_torch.run import build_card, load_weights
        whole = load_weights(build_card(spec.checkpoint), spec.model_cfg,
                             "cpu")
        params = llama.shard_params(whole, spec.model_cfg, rank, spec.tp,
                                    device)
        del whole
    return NativeEngine(spec.model_cfg, spec.engine_cfg, params=params,
                        eos_token_ids=set(spec.eos_token_ids or ()),
                        seed=spec.seed, device=device, mesh=mesh)


def _die_with_parent() -> None:
    """preexec_fn: SIGTERM this child when its parent dies (Linux)."""
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    except OSError:
        pass


def spawn_followers(spec: RankSpec) -> list:
    blob = base64.b64encode(pickle.dumps(spec)).decode()
    procs = []
    for rank in range(1, spec.tp):
        env = dict(os.environ, DYN_COORD_ADDR=f"127.0.0.1:{spec.port}",
                   DYN_NUM_PROCESSES=str(spec.tp), DYN_PROCESS_ID=str(rank))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH", "")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.parallel.launch",
             "--follower", blob], env=env, stdout=subprocess.DEVNULL,
            # a terminal's Ctrl-C reaches rank 0 alone, which then closes
            # the group in order
            start_new_session=True, preexec_fn=_die_with_parent))
    return procs


def _end(procs: list, wait_s: float) -> list:
    """Each follower's exit code, after waiting up to wait_s for all of
    them; one still running is killed (its code is then negative)."""
    deadline = time.monotonic() + wait_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


@contextlib.contextmanager
def tp_engine(model_cfg: ModelConfig, engine_cfg: EngineConfig,
              device: str = "cuda", backend: Optional[str] = None,
              devices: Optional[Sequence] = None, seed: int = 0,
              eos_token_ids=None, weights_npz: Optional[str] = None,
              checkpoint: Optional[str] = None, timeout_s: float = 600.0):
    """Rank 0's engine of a group of `engine_cfg.tp` ranks (the others run
    as processes; see the module docstring), for the body of the `with`.
    On leaving, rank 0 closes its engine, which releases the followers,
    and a follower that failed raises here. A group of one rank is a group
    all the same: its engine calls the collectives."""
    devices, backend = rank_devices(engine_cfg.tp, device, backend, devices)
    if devices[0].startswith("cuda"):
        from dynamo_tpu_torch.ops import build
        build.build()
    spec = RankSpec(model_cfg, engine_cfg, devices, backend, free_port(),
                    seed, sorted(eos_token_ids or ()), weights_npz,
                    checkpoint, timeout_s)
    procs = spawn_followers(spec)
    clean = False
    try:
        bootstrap_distributed(f"127.0.0.1:{spec.port}", spec.tp, 0,
                              device=devices[0], backend=backend,
                              timeout_s=timeout_s)
        engine = build_rank_engine(spec, 0, world_comm(devices[0], backend))
        yield engine
        engine.close()
        clean = True
    finally:
        codes = _end(procs, timeout_s if clean else 5.0)
        shutdown()
    bad = {r + 1: c for r, c in enumerate(codes) if c != 0}
    if bad:
        raise RuntimeError(f"tensor-parallel followers failed (rank: exit "
                           f"code): {bad}")


def follower_main(blob: str) -> int:
    spec: RankSpec = pickle.loads(base64.b64decode(blob))
    rank = int(os.environ["DYN_PROCESS_ID"])
    device = spec.devices[rank]
    if device.startswith("cuda"):
        import torch
        torch.cuda.set_device(device)
    bootstrap_distributed(device=device, backend=spec.backend,
                          timeout_s=spec.timeout_s)
    engine = build_rank_engine(spec, rank, world_comm(device, spec.backend))
    engine.follow()
    shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["--follower"] or len(sys.argv) != 3:
        sys.exit("usage: python -m dynamo_tpu_torch.parallel.launch "
                 "--follower SPEC (started by tp_engine)")
    sys.exit(follower_main(sys.argv[2]))
