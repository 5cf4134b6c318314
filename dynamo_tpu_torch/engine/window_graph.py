"""Decode windows as captured CUDA graphs.

The port's counterpart of the JAX engine's `_decode_fns` jit dict
(dynamo_tpu/engine/engine.py:368-378): one device program per window
variant, built on first use and dispatched once per window. PyTorch runs
eagerly, so its device program is a CUDA graph. A window of N steps at
llama3-8b is ~3500 kernel launches a step; replaying them as one graph
takes the host's launch work out of the step. Speculative decoding's
programs are graphs of the same kind: the verify forward (the JAX
`_verify_fn`, dynamo_tpu/engine/engine.py:405), keyed ("verify", S,
spec_k + 1, Pb), and the draft model's K proposal steps (the JAX
`_propose_fn`, dynamo_tpu/engine/spec.py:247-252), keyed ("propose", S,
Pb) in the draft's own WindowGraphs.

- Keys. A graph is keyed by the window's variant `(rp, lp, greedy, fused,
  nw)` plus every shape it closes over (S, Pb, the stop-id width K and the
  penalty history width): the same set of programs the JAX engine compiles.
- Capture. On first use at a key, the program runs once eagerly on the
  engine's stream with every row dead (`max_pos` = -1, so its KV writes land
  in the cache's scratch page and nothing else changes). That warm-up builds
  and loads the kernel library and takes its one-time shared-memory opt-in
  and cuBLAS's lazy set-up out of the capture. Then the program is captured
  on the same stream, into one memory pool that every window graph shares
  (they replay one after another on one stream; after a capture that failed
  to end, later graphs share a fresh one). The capture runs in the
  thread-local error mode, so CUDA work of another thread (a second engine
  in the process) does not invalidate it, and holds `capture_lock`: code
  that stages device memory for this engine from another thread (the KV
  receiver's host-to-device copies) takes it too, so none of its
  allocations overlaps a capture. It also holds the process-wide
  `CAPTURES`: a capture's set-up synchronizes the device and empties the
  allocator's cache, which fails while another engine's capture is in
  progress on another thread and invalidates that capture (two engines
  that capture in one process: chip_smoke.py phase 16c's routed pair).
- Buffers. Inputs are static buffers, one set per shape (`inputs`), shared
  by the variants of that shape; the engine uploads a plan into them.
  Buffers that every graph shares whatever its shapes (`static`: the gather
  window's base and window buffers, sized once for the largest window) are
  allocated here too, outside every capture, so no graph's pool holds a
  copy of them. The
  program writes its final (token, position, counter) carry back into its
  own input buffers, so a follow-up window replays with no copy at all.
  Outputs live in the pool and are valid until the next replay of any
  graph: `HostCopies` copies them to pinned host memory right after each
  replay.
- Launch counts. A kernel wrapper called during capture launches nothing
  and counts a captured call (ops/paged_attention.py, ops/quant.py); each
  replay adds the calls its graph holds to each wrapper's launch count
  (`KERNELS` names them). The replays are also counted by the decode path
  their programs run ("ragged" or "gather": `replay_paths`); a gather
  graph holds no ragged call.
- Collectives. A tensor-parallel window's all-reduces are counted the same
  way (`COLLECTIVES`: parallel/comm.py's counters; `replay_collectives`,
  `captured_collectives()`): under NCCL a graph captures them; a gloo
  engine's windows run eagerly (`eager`), as gloo cannot be captured.
- Outputs of MoE windows include the window's summed expert-dispatch
  counts; like the tokens they are copied out after each replay, so a
  warm-up or a replay whose outputs are never read counts nothing.

On CPU tensors `run` calls the program directly: the tests run the same
function eagerly, as a kernel's wrapper takes its plain version for CPU
tensors. On the card every window is one replay; a capture or replay that
fails raises, and nothing falls back to eager. `eager = True` runs every
window directly on the card too, graphs aside: a reference for the graph
windows, and the mode of an engine on a gloo group; `eager_runs` counts
the windows so run (every window on the CPU). A failed capture is taken
apart before it raises (the pool no longer takes the stream's allocations,
the half-built graph is dropped), so the next `run` captures afresh.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import torch

from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import quant
from dynamo_tpu_torch.parallel import comm

# every kernel a window program can launch: name -> (its wrapper's module,
# the launch counter, the captured-call counter)
KERNELS = {
    "ragged_decode_attention": (pa, "KERNEL_LAUNCHES", "CAPTURED_CALLS"),
    "w8a16_gemm": (quant, "KERNEL_LAUNCHES", "CAPTURED_CALLS"),
    "w8a16_dequant": (quant, "DEQUANT_LAUNCHES", "DEQUANT_CAPTURED"),
    "w8a16_moe_gemm": (quant, "MOE_LAUNCHES", "MOE_CAPTURED"),
    "w8a16_large_m": (quant, "LARGE_M_LAUNCHES", "LARGE_M_CAPTURED"),
}


# the collectives a tensor-parallel window calls, counted like the kernels
COLLECTIVES = {
    "tp_all_reduce": (comm, "ALL_REDUCES", "ALL_REDUCES_CAPTURED"),
}


def _counts(which: int, table: dict = KERNELS) -> Dict[str, int]:
    """{kernel: its launch count (which=1) or captured calls (which=2)}."""
    return {name: getattr(k[0], k[which]) for name, k in table.items()}


# one capture at a time in the process (see "Capture" above)
CAPTURES = threading.Lock()


class WindowGraphs:
    """The captured decode-window programs of one engine."""

    def __init__(self, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.device = device
        # the engine's stream: warm-up, capture and every replay run on it
        self.stream = stream
        self._inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        # key -> (graph, outs, {kernel: calls captured}, {collective:
        # calls captured})
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._pools = set()     # every pool the held graphs live in
        # held for each capture (see the module docstring)
        self.capture_lock = threading.Lock()
        self.captured = 0           # graphs captured since the last reset
        self.capture_times: list = []  # time.time() at each capture
        self.resets = 0             # times every graph was dropped
        self.warmup_seconds = 0.0   # wall time of the eager warm-ups
        self.capture_seconds = 0.0  # wall time of the captures
        self.replays = 0
        # kernel launches of the eager warm-ups, and those the replays added,
        # by kernel
        self.warmup_launches = {name: 0 for name in KERNELS}
        self.replay_launches = {name: 0 for name in KERNELS}
        self.replay_paths: Dict[str, int] = {}   # decode path -> replays
        self.replay_collectives = {name: 0 for name in COLLECTIVES}
        self._static: Dict[str, torch.Tensor] = {}
        self.eager = False   # run windows directly (see above)
        self.eager_runs = 0  # programs run directly (CPU, or eager)

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

    def static(self, name: str, numel: int,
               dtype: torch.dtype) -> torch.Tensor:
        """A flat buffer of `numel` elements shared by every graph, made
        once (zero-filled) at its first request; callers view prefixes of
        it. A later request for more than it holds raises: it was sized
        for the largest."""
        buf = self._static.get(name)
        if buf is None:
            buf = self._static[name] = torch.zeros(numel, dtype=dtype,
                                                   device=self.device)
        if buf.numel() < numel or buf.dtype != dtype:
            raise ValueError(f"static buffer {name!r} holds {buf.numel()} "
                             f"{buf.dtype}, asked for {numel} {dtype}")
        return buf

    def run(self, key: tuple, program: Callable,
            bufs: Dict[str, torch.Tensor], path: str = "",
            dead: str = "max_pos"):
        """Run the program `program(bufs)` keyed by `key` (the decode
        `path` it runs, or "verify" / "propose" for speculative decoding):
        directly on the CPU (or with `eager`); on the card as the replay of
        its graph, captured first if the key is new. `dead` names the input
        that, filled with -1, kills every row for the warm-up (a window's
        max_pos, a verify's write_idx, a proposal's max_write). Returns the
        program's outputs (on the card, the graph's pool tensors)."""
        if self.device.type != "cuda" or self.eager:
            self.eager_runs += 1
            return program(bufs)
        with torch.cuda.stream(self.stream):
            rec = self._graphs.get(key)
            if rec is None:
                rec = self._capture(key, program, bufs, dead)
            graph, outs, calls, colls = rec
            graph.replay()
        for table, got, added in ((KERNELS, calls, self.replay_launches),
                                  (COLLECTIVES, colls,
                                   self.replay_collectives)):
            for name, n in got.items():
                mod, attr = table[name][:2]
                setattr(mod, attr, getattr(mod, attr) + n)
                added[name] += n
        self.replays += 1
        self.replay_paths[path] = self.replay_paths.get(path, 0) + 1
        return outs

    def _capture(self, key: tuple, program: Callable, bufs,
                 dead: str = "max_pos") -> tuple:
        t0 = time.perf_counter()
        # warm-up on copies of the inputs with every row dead: same shapes
        # and launches, writes only the scratch page, changes no carry
        idle = {name: t.clone() for name, t in bufs.items()}
        idle[dead].fill_(-1)
        n0 = _counts(1)
        program(idle)
        self.stream.synchronize()
        for name, n in _counts(1).items():
            self.warmup_launches[name] += n - n0[name]
        t1 = time.perf_counter()
        self.warmup_seconds += t1 - t0
        pool = (self._pool if self._pool is not None
                else torch.cuda.graph_pool_handle())
        graph = torch.cuda.CUDAGraph()
        c0 = _counts(2)
        k0 = _counts(2, COLLECTIVES)
        # torch.cuda.graph's entry, spelled out so that a capture that fails
        # can be taken apart (_discard)
        with CAPTURES, self.capture_lock:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            ended = False
            try:
                try:
                    outs = program(bufs)
                finally:
                    # raises when the capture was invalidated
                    graph.capture_end()
                    ended = True
            except BaseException:
                self._discard(graph, pool, ended)
                raise
        self._pool = pool
        self._pools.add(pool)
        rec = (graph, outs,
               {name: n - c0[name] for name, n in _counts(2).items()},
               {name: n - k0[name]
                for name, n in _counts(2, COLLECTIVES).items()})
        self._graphs[key] = rec
        self.captured += 1
        self.capture_times.append(time.time())
        self.capture_seconds += time.perf_counter() - t1
        return rec

    def _discard(self, graph, pool, ended: bool) -> None:
        """Undo a capture that raised, so the next one starts as if this had
        never begun. The allocator stops routing the stream's allocations
        into the pool (a capture that failed in `capture_end` never told
        it to), and the graph's use of the pool is released: by the graph
        itself where its capture ended, else here. The allocator refuses to
        record into a pool again after a capture into it failed to end, so
        then the next graph starts a fresh pool (`_pool` None); the graphs
        captured before keep theirs."""
        dev = self.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
               or torch._C._cuda_endAllocateCurrentStreamToPool)
        try:
            end(dev, pool)
        except RuntimeError:
            pass    # capture_end had ended the routing already
        if ended:
            graph.reset()
        else:
            torch._C._cuda_releasePool(dev, pool)
            self._pool = None

    def captured_calls(self) -> Dict[tuple, Dict[str, int]]:
        """{graph key: {kernel: calls its graph holds}} of the graphs held."""
        return {key: dict(rec[2]) for key, rec in self._graphs.items()}

    def captured_collectives(self) -> Dict[tuple, Dict[str, int]]:
        """{graph key: {collective: calls its graph holds}}."""
        return {key: dict(rec[3]) for key, rec in self._graphs.items()}

    def pool_bytes(self) -> int:
        """Device bytes held by the graphs' memory pools."""
        if not self._pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in self._pools)

    def reset(self) -> None:
        """Drop every graph and its pool: they hold the addresses of the
        cache they were captured over. The caller has synchronized the
        stream, so no replay is still reading them."""
        self._graphs.clear()
        self.capture_times = []
        self._pool = None
        self._pools = set()
        self.captured = 0
        self.resets += 1


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
