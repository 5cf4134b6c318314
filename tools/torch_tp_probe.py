"""What the card's collectives do for a tensor-parallel engine, in one run:

    python3 tools/torch_tp_probe.py

1. NCCL at one rank: an all-reduce captured in a CUDA graph between two
   bf16 products replays bit-equal to the eager run, and torch.profiler
   lists the CUDA kernels of one replay and the NCCL events of two eager
   all-reduces (one rank: NCCL launches no kernel for an in-place sum).
2. gloo on CUDA tensors with 1 and with 4 ranks of one card (processes):
   each all-reduce of 64 Ki and of 2 Mi bf16 values correct, its mean ms
   over 20, and whether a CUDA graph can capture it (it cannot).

Needs one card; prints nvidia-smi's name and power limit first."""
import json, os, subprocess, sys, time
import torch, torch.distributed as dist

def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

def nccl_one():
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:29611",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    dev = torch.device("cuda:0")
    x = torch.randn(8, 8192, device=dev, dtype=torch.bfloat16)
    w = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    dist.all_reduce(x)          # warm the communicator
    torch.cuda.synchronize()
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream())
    out = {}
    with torch.cuda.stream(s):
        y = x @ w; dist.all_reduce(y); z = y @ w
        ref = z.clone()
        g = torch.cuda.CUDAGraph()
        g.capture_begin(capture_error_mode="thread_local")
        y2 = x @ w; dist.all_reduce(y2); z2 = y2 @ w
        g.capture_end()
        g.replay()
    s.synchronize()
    out["graph_equal"] = bool(torch.equal(z2, ref))
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(s):
            g.replay()
        s.synchronize()
    out["replay_events"] = sorted({e.name for e in prof.events()
                                   if e.device_type.name == "CUDA"})[:40]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(x); torch.cuda.synchronize()
        y = x.clone(); dist.all_reduce(y, op=dist.ReduceOp.MAX); torch.cuda.synchronize()
    out["eager_events"] = sorted({e.name for e in prof.events()
                                  if "nccl" in e.name.lower()})
    dist.destroy_process_group()
    return out

def gloo_rank(r, n, port, q):
    import torch, torch.distributed as dist, time
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=r)
    dev = torch.device("cuda:0")
    res = {}
    for numel in (8 * 8192, 8 * 128256 * 2):
        x = torch.full((numel,), float(r + 1), device=dev, dtype=torch.bfloat16)
        dist.all_reduce(x); torch.cuda.synchronize()
        ok = bool((x == sum(range(1, n + 1))).all())
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        res[numel] = (ok, (time.perf_counter() - t0) / 20 * 1e3)
    try:
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            g.capture_begin(capture_error_mode="thread_local")
            dist.all_reduce(x)
            g.capture_end()
        res["capture"] = "ok"
    except Exception as e:
        res["capture"] = f"{type(e).__name__}: {str(e)[:200]}"
    q.put((r, res))
    dist.destroy_process_group()

if __name__ == "__main__":
    print(smi(), torch.__version__, torch.version.cuda, torch.cuda.nccl.version(), flush=True)
    t0 = time.time()
    print("nccl world 1:", json.dumps(nccl_one()), f"{time.time()-t0:.1f}s", flush=True)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    for n in (1, 4):
        q = ctx.Queue()
        t0 = time.time()
        ps = [ctx.Process(target=gloo_rank, args=(r, n, 29700 + n, q)) for r in range(n)]
        [p.start() for p in ps]
        res = [q.get(timeout=300) for _ in ps]
        [p.join(60) for p in ps]
        print(f"gloo world {n} on cuda:0:", sorted(res), f"{time.time()-t0:.1f}s", flush=True)
