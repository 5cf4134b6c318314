"""Decode windows as captured CUDA graphs.

The port's counterpart of the JAX engine's `_decode_fns` jit dict
(dynamo_tpu/engine/engine.py:368-378): one device program per window
variant, built on first use and dispatched once per window. PyTorch runs
eagerly, so its device program is a CUDA graph. A window of N steps at
llama3-8b is ~3500 kernel launches a step; replaying them as one graph
takes the host's launch work out of the step.

- Keys. A graph is keyed by the window's variant `(rp, lp, greedy, fused,
  nw)` plus every shape it closes over (S, Pb, the stop-id width K and the
  penalty history width): the same set of programs the JAX engine compiles.
- Capture. On first use at a key, the program runs once eagerly on the
  engine's stream with every row dead (`max_pos` = -1, so its KV writes land
  in the cache's scratch page and nothing else changes). That warm-up builds
  and loads the kernel library and takes its one-time shared-memory opt-in
  and cuBLAS's lazy set-up out of the capture. Then the program is captured
  on the same stream, into one memory pool that every window graph shares
  (they replay one after another on one stream).
- Buffers. Inputs are static buffers, one set per shape (`inputs`), shared
  by the variants of that shape; the engine uploads a plan into them. The
  program writes its final (token, position, counter) carry back into its
  own input buffers, so a follow-up window replays with no copy at all.
  Outputs live in the pool and are valid until the next replay of any
  graph: `HostCopies` copies them to pinned host memory right after each
  replay.
- Launch counts. A kernel wrapper called during capture launches nothing
  and counts a captured call (ops/paged_attention.py, ops/quant.py); each
  replay adds the calls its graph holds to each wrapper's launch count
  (`KERNELS` names them).

On CPU tensors `run` calls the program directly: the tests run the same
function eagerly, as a kernel's wrapper takes its plain version for CPU
tensors. On the card every window is one replay; a capture or replay that
fails raises, and nothing falls back to eager.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import quant

# every kernel a window program can launch: name -> (its wrapper's module,
# the launch counter, the captured-call counter)
KERNELS = {
    "ragged_decode_attention": (pa, "KERNEL_LAUNCHES", "CAPTURED_CALLS"),
    "w8a16_gemm": (quant, "KERNEL_LAUNCHES", "CAPTURED_CALLS"),
    "w8a16_dequant": (quant, "DEQUANT_LAUNCHES", "DEQUANT_CAPTURED"),
}


def _counts(which: int) -> Dict[str, int]:
    """{kernel: its launch count (which=1) or captured calls (which=2)}."""
    return {name: getattr(k[0], k[which]) for name, k in KERNELS.items()}


class WindowGraphs:
    """The captured decode-window programs of one engine."""

    def __init__(self, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.device = device
        # the engine's stream: warm-up, capture and every replay run on it
        self.stream = stream
        self._inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        # key -> (graph, outs, {kernel: calls captured})
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self.captured = 0           # graphs captured since the last reset
        self.warmup_seconds = 0.0   # wall time of the eager warm-ups
        self.capture_seconds = 0.0  # wall time of the captures
        self.replays = 0
        # kernel launches of the eager warm-ups, and those the replays added,
        # by kernel
        self.warmup_launches = {name: 0 for name in KERNELS}
        self.replay_launches = {name: 0 for name in KERNELS}

    def inputs(self, shapes: tuple,
               spec: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """The static input buffers for one set of shapes: {name: tensor}
        made once from spec {name: (shape, dtype)}, zero-filled."""
        bufs = self._inputs.get(shapes)
        if bufs is None:
            bufs = {name: torch.zeros(shape, dtype=dtype, device=self.device)
                    for name, (shape, dtype) in spec.items()}
            self._inputs[shapes] = bufs
        return bufs

    def run(self, key: tuple, program: Callable, bufs: Dict[str, torch.Tensor]):
        """Run the window program `program(bufs)` keyed by `key`: directly on
        the CPU; on the card as the replay of its graph, captured first if
        the key is new. Returns the program's outputs (on the card, the
        graph's pool tensors)."""
        if self.device.type != "cuda":
            return program(bufs)
        with torch.cuda.stream(self.stream):
            rec = self._graphs.get(key)
            if rec is None:
                rec = self._capture(key, program, bufs)
            graph, outs, calls = rec
            graph.replay()
        for name, n in calls.items():
            mod, attr = KERNELS[name][:2]
            setattr(mod, attr, getattr(mod, attr) + n)
            self.replay_launches[name] += n
        self.replays += 1
        return outs

    def _capture(self, key: tuple, program: Callable, bufs) -> tuple:
        t0 = time.perf_counter()
        # warm-up on copies of the inputs with every row dead: same shapes
        # and launches, writes only the scratch page, changes no carry
        idle = {name: t.clone() for name, t in bufs.items()}
        idle["max_pos"].fill_(-1)
        n0 = _counts(1)
        program(idle)
        self.stream.synchronize()
        for name, n in _counts(1).items():
            self.warmup_launches[name] += n - n0[name]
        t1 = time.perf_counter()
        self.warmup_seconds += t1 - t0
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        c0 = _counts(2)
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
            outs = program(bufs)
        rec = (graph, outs, {name: n - c0[name]
                             for name, n in _counts(2).items()})
        self._graphs[key] = rec
        self.captured += 1
        self.capture_seconds += time.perf_counter() - t1
        return rec

    def captured_calls(self) -> Dict[tuple, Dict[str, int]]:
        """{graph key: {kernel: calls its graph holds}} of the graphs held."""
        return {key: dict(rec[2]) for key, rec in self._graphs.items()}

    def pool_bytes(self) -> int:
        """Device bytes held by the graphs' shared memory pool."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    def reset(self) -> None:
        """Drop every graph and its pool: they hold the addresses of the
        cache they were captured over. The caller has synchronized the
        stream, so no replay is still reading them."""
        self._graphs.clear()
        self._pool = None
        self.captured = 0


class HostCopies:
    """Pinned host buffers for window outputs, one set per window that can
    be in flight (the in-flight window and its follow-up): a follow-up
    replay overwrites the graph's outputs before the host has read the
    window before it, so each window's device->host copy is enqueued right
    after its replay, into buffers that belong to that window."""

    def __init__(self, slots: int = 2):
        self._bufs = [{} for _ in range(slots)]
        self._events = [None] * slots
        self._next = 0

    def copy_async(self, outs: tuple, stream) -> tuple:
        """Enqueue the copy of outs (tensors or None) on `stream` and record
        an event after it; returns the handle `wait` takes. CPU outputs are
        the window's own fresh tensors and are handed back as they are."""
        first = next(t for t in outs if t is not None)
        if first.device.type != "cuda":
            return outs, None
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        bufs, host = self._bufs[slot], []
        with torch.cuda.stream(stream):
            for i, t in enumerate(outs):
                if t is None:
                    host.append(None)
                    continue
                k = (i, tuple(t.shape), t.dtype)
                b = bufs.get(k)
                if b is None:
                    b = bufs[k] = torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True)
                b.copy_(t, non_blocking=True)
                host.append(b)
        ev = self._events[slot]
        if ev is None:
            ev = self._events[slot] = torch.cuda.Event()
        ev.record(stream)
        return tuple(host), ev

    @staticmethod
    def wait(handle) -> tuple:
        """Wait for one window's copy (its event and nothing else); its
        outputs as numpy arrays (None stays None)."""
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return tuple(None if t is None else t.numpy() for t in host)
