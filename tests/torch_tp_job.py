"""Rank 0 of a tensor-parallel port engine on the CPU, for
tests/test_torch_tp.py: `python tests/torch_tp_job.py JOB.pkl OUT.pkl`.

JOB is a pickled dict: the port's model and engine configs (engine_cfg.tp
ranks), the JAX-layout weights as an .npz (parallel/launch.save_tree), the
eos ids and `batches`, each a list of (request id, prompt ids, sampling
kwargs) added together and stepped to completion, one batch after the
other on the one engine; with `worker` set, one more request goes through
a NativeEngineWorker served on a memory control plane, and its $STATS
reply is scraped. OUT holds each batch's streams and finish reasons,
`metrics()` as a dict, every rank's `tp_stats()` (taken with a wait) and
the $STATS reply. The ranks are processes (parallel/launch.tp_engine over
gloo); a test runs this script as a subprocess of its own with a time
limit, so a hung rank fails that test and nothing else.
"""
import asyncio
import dataclasses
import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from dynamo_tpu_torch.engine.scheduler import (  # noqa: E402
    EngineRequest, SamplingParams,
)
from dynamo_tpu_torch.parallel.launch import tp_engine  # noqa: E402


def drive(engine, batch) -> tuple:
    for rid, prompt, kw in batch:
        engine.add_request(EngineRequest(rid, list(prompt),
                                         SamplingParams(**kw)))
    out = {rid: [] for rid, _, _ in batch}
    finish = {}
    while engine.has_work():
        for ev in engine.step():
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
            if ev.finished:
                finish[ev.request_id] = ev.finish_reason
    return out, finish


async def worker_stats(engine, prompt: list) -> dict:
    """One request through a served worker, then its $STATS scrape."""
    from dynamo_tpu_torch.llm.worker import (
        NativeEngineWorker, serve_llm_worker,
    )
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, StopConditions,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
    worker = await NativeEngineWorker(engine).start()
    plane = MemoryPlane()
    wrt = await DistributedRuntime.create_local(plane, "w0")
    crt = await DistributedRuntime.create_local(plane, "fe")
    try:
        await serve_llm_worker(wrt, "ns", "llm", worker)
        client = crt.namespace("ns").component("llm").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        frames = [f async for f in await client.generate(PreprocessedRequest(
            "w", prompt, stop=StopConditions(max_tokens=4)))]
        stats = (await client.scrape_stats())["w0"]
        # frames cross the plane as wire dicts
        return {"tokens": [t for f in frames for t in f["token_ids"]],
                "stats": stats}
    finally:
        await wrt.shutdown()
        await crt.shutdown()
        await worker.stop()


def main() -> int:
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    out = {}
    with tp_engine(job["model_cfg"], job["engine_cfg"], device="cpu",
                   eos_token_ids=job["eos"], weights_npz=job["weights"],
                   timeout_s=job.get("timeout_s", 120.0)) as engine:
        out["streams"] = [drive(engine, b) for b in job["batches"]]
        out["metrics"] = dataclasses.asdict(engine.metrics())
        out["ranks"] = engine.tp_stats(sync=True)
        if job.get("worker"):
            out["worker"] = asyncio.run(asyncio.wait_for(
                worker_stats(engine, job["worker"]), 60))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
