"""Tensor parallelism of the port's engine against the JAX package's.

Each configuration runs the port's engine as gloo ranks spawned as
processes on the CPU (tests/torch_tp_job.py: parallel/launch.tp_engine,
rank 0 driving, the others following its launches), on the weights of a
JAX engine carried over as numpy (every rank cuts its shard with
params_from_jax), and holds every stream token for token to the JAX
package's NativeEngine on a `make_mesh(tp=N)` over conftest's 8 CPU
devices, in float32: greedy, seeded-sampled, chunked prefill and mixed
steps, int8 KV pages (greedy only: int8 x seeded-sampled is a reference
fault, ROADMAP.md §C), the gather window (decode_kernel="off"), and an MQA
head count that tp does not divide (the gather window with the JAX
engine's reason, held to JAX's log; the JAX engine itself cannot shard
that cache over the mesh, so those streams are held to its tp-1 engine). Every rank's tokens equal rank 0's
(the ranks' on-device check and their token digests), and the metrics and
the $STATS reply of a tp-2 worker carry tp, the rank, the backend, the
window-graph mode and each rank's launches. Then `run.py in=batch --tp 2
--device cpu` against `--tp 1`, and the refusals named.

One spawn a configuration, shared by its cases through a module-scoped
cache; each spawn has a free port and a time limit of its own (a hung
rank fails its cases and stalls nothing else).
"""
import dataclasses
import json
import logging
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
)
from dynamo_tpu.engine.engine import NativeEngine as JNativeEngine
from dynamo_tpu.engine.scheduler import (
    EngineRequest as JRequest, SamplingParams as JSamplingParams,
)
from dynamo_tpu.parallel.mesh import make_mesh as jmake_mesh
from dynamo_tpu_torch.engine.config import (
    EngineConfig as TEngineConfig, ModelConfig as TModelConfig,
)
from dynamo_tpu_torch.parallel.launch import save_tree

REPO = pathlib.Path(__file__).resolve().parent.parent
JOB = REPO / "tests" / "torch_tp_job.py"
SPAWN_TIMEOUT_S = 240
EOS = {2}
ENGINE_KW = dict(page_size=8, num_pages=64, max_slots=4,
                 max_prefill_chunk=32, prefill_buckets=(8, 16, 32),
                 max_model_len=512)
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_model_len=512, dtype="float32")
# the JAX bootstrap's dry-run geometry (8 / 4 heads of 32)
MPDRY = dict(TINY, name="mp-dry", num_heads=8, num_kv_heads=4)
# one kv head: tp=2 divides the q heads, not the kv heads
MQA = dict(TINY, name="tiny-mqa", num_kv_heads=1)

BATCHES = {
    "greedy": [("g1", range(10, 30), dict(max_tokens=12)),
               ("g2", range(50, 63), dict(max_tokens=9))],
    "sampled": [("s1", range(40, 61), dict(max_tokens=10, temperature=0.8,
                                           top_k=20, seed=7)),
                ("s2", range(3, 20), dict(max_tokens=9, temperature=1.1,
                                          top_p=0.9, seed=3))],
    # a 75-token prompt through 32-token chunks
    "chunked": [("c1", list(range(5, 80)), dict(max_tokens=8))],
    # staggered lengths: decode rows ride along later prompts' chunks
    "mixed": [("m1", range(7, 19), dict(max_tokens=14)),
              ("m2", list(range(100, 170)), dict(max_tokens=6)),
              ("m3", range(200, 240), dict(max_tokens=10, temperature=0.9,
                                           seed=5))],
}

# name -> (model fields, port decode_kernel, JAX decode_kernel, tp,
#          engine knobs, batches, serve a worker, the JAX engine's tp)
CASES = {
    "tiny-tp2": (TINY, "auto", "off", 2, {},
                 ("greedy", "sampled", "chunked", "mixed"), False, 2),
    "tiny-tp2-gather": (TINY, "off", "off", 2, {}, ("greedy", "sampled"),
                        False, 2),
    "tiny-tp2-int8-pages": (TINY, "auto", "off", 2, {"kv_quant": "int8"},
                            ("greedy", "chunked"), False, 2),
    "mpdry-tp4": (MPDRY, "auto", "off", 4, {},
                  ("greedy", "sampled", "mixed"), False, 4),
    # the JAX tp-2 engine refuses this cache (one kv head over two
    # devices): its tp-1 engine is the reference
    "mqa-tp2": (MQA, "on", "off", 2, {}, ("greedy", "sampled"), True, 1),
}
STREAM_CASES = [(c, b) for c, spec in CASES.items() for b in spec[5]]
WORKER_PROMPT = list(range(3, 30))

_RUNS: dict = {}


def _jax_side(name: str, tree) -> dict:
    fields, _, jkernel, _, knobs, batches, _, jtp = CASES[name]
    jcfg = JModelConfig(**dict(fields, decode_kernel=jkernel))
    ecfg = JEngineConfig(**ENGINE_KW, tp=jtp, **knobs)
    eng = JNativeEngine(jcfg, ecfg, mesh=jmake_mesh(tp=jtp), params=tree,
                        eos_token_ids=EOS, seed=0)
    streams = []
    for b in batches:
        reqs = BATCHES[b]
        for rid, prompt, kw in reqs:
            eng.add_request(JRequest(rid, list(prompt), JSamplingParams(**kw)))
        out = {rid: [] for rid, _, _ in reqs}
        finish = {}
        while eng.has_work():
            for ev in eng.step():
                if ev.token is not None:
                    out[ev.request_id].append(ev.token)
                if ev.finished:
                    finish[ev.request_id] = ev.finish_reason
        streams.append((out, finish))
    worker = None
    if CASES[name][6]:
        # the worker's one request, greedy, 4 tokens, after the batches
        eng.add_request(JRequest("w", WORKER_PROMPT,
                                 JSamplingParams(max_tokens=4)))
        worker = []
        while eng.has_work():
            worker += [ev.token for ev in eng.step() if ev.token is not None]
    return {"streams": streams, "worker": worker}


def _run(name: str) -> dict:
    """The configuration's port run (spawned first) and JAX run, once."""
    if name in _RUNS:
        return _RUNS[name]
    fields, tkernel, jkernel, tp, knobs, batches, worker, _ = CASES[name]
    # the weights: a JAX tp-1 engine's seed-0 draw
    base = JNativeEngine(JModelConfig(**dict(fields, decode_kernel=jkernel)),
                         JEngineConfig(**ENGINE_KW), seed=0)
    tree = jax.device_get(base.params)
    del base
    tmp = tempfile.mkdtemp(prefix="torch_tp_")
    weights = os.path.join(tmp, "w.npz")
    save_tree(weights, tree)
    job = {"model_cfg": TModelConfig(**dict(fields, decode_kernel=tkernel)),
           "engine_cfg": TEngineConfig(**ENGINE_KW, tp=tp, **knobs),
           "weights": weights, "eos": sorted(EOS),
           "batches": [[(r, list(p), kw) for r, p, kw in BATCHES[b]]
                       for b in batches],
           "worker": WORKER_PROMPT if worker else None,
           "timeout_s": 120.0}
    job_path, out_path = os.path.join(tmp, "job.pkl"), os.path.join(
        tmp, "out.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(JOB), job_path, out_path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    jout = _jax_side(name, tree)        # while the ranks run
    try:
        log, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        pytest.fail(f"{name}: the tp job outlived {SPAWN_TIMEOUT_S} s:\n"
                    f"{log[-3000:]}")
    assert proc.returncode == 0, f"{name}: tp job failed:\n{log[-3000:]}"
    with open(out_path, "rb") as f:
        tout = pickle.load(f)
    _RUNS[name] = {"port": tout, "jax": jout}
    return _RUNS[name]


@pytest.mark.parametrize("case,batch", STREAM_CASES,
                         ids=[f"{c}-{b}" for c, b in STREAM_CASES])
def test_streams_equal_jax_tp_engine(case, batch):
    run = _run(case)
    i = CASES[case][5].index(batch)
    port, ref = run["port"]["streams"][i], run["jax"]["streams"][i]
    assert port == ref
    assert set(port[1]) == {rid for rid, _, _ in BATCHES[batch]}
    assert sum(len(t) for t in port[0].values()) > len(BATCHES[batch])


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_samples_rank0_tokens(case):
    """The on-device check of every launch counted no mismatch on any rank,
    and every rank's digest of its sampled tokens is rank 0's; every rank
    ran the same windows and collectives."""
    ranks = _run(case)["port"]["ranks"]
    tp = CASES[case][3]
    assert [r["rank"] for r in ranks] == list(range(tp))
    assert all(r["token_mismatches"] == 0 for r in ranks)
    assert len({r["token_digest"] for r in ranks}) == 1
    assert ranks[0]["token_digest"] != 0
    for key in ("all_reduces", "decode_windows", "eager_windows"):
        assert len({r[key] for r in ranks}) == 1, key
    assert ranks[0]["all_reduces"] > 0
    assert all(r["nonfinite_steps"] == 0 for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_report_the_mesh(case):
    fields, tkernel, _, tp, knobs, _, _, _ = CASES[case]
    m = _run(case)["port"]["metrics"]
    assert (m["tp"], m["tp_rank"], m["tp_backend"]) == (tp, 0, "gloo")
    assert m["window_graphs"] == "off (cpu)"
    assert m["eager_windows"] == m["decode_windows"] > 0
    assert len(m["tp_ranks"]) == tp
    # every rank holds its shard: the same bytes on every rank here (q,
    # kv, FFN and vocab all split evenly or, MQA, one kv head each)
    assert len({r["weight_bytes"] for r in m["tp_ranks"]}) == 1
    gather = tkernel == "off" or fields["num_kv_heads"] % tp
    assert m["decode_path"] == ("gather" if gather else "ragged")


def test_decode_path_reason_is_jax_on_a_head_count_tp_does_not_divide():
    """The JAX engine on a tp-2 mesh, asked for its kernel, disables it
    with this reason (and then refuses to shard one kv head over two
    devices); the port resolves the gather window with the same reason
    and serves the model."""
    m = _run("mqa-tp2")["port"]["metrics"]
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())
    log = logging.getLogger("dynamo_tpu.engine.engine")
    grab = Grab()
    log.addHandler(grab)
    try:
        with pytest.raises(ValueError, match="divisible by 2"):
            JNativeEngine(JModelConfig(**dict(MQA, decode_kernel="on")),
                          JEngineConfig(**ENGINE_KW, tp=2),
                          mesh=jmake_mesh(tp=2), seed=0)
    finally:
        log.removeHandler(grab)
    reason = "num_heads=4 / num_kv_heads=1 not divisible by tp=2"
    assert any(reason in line for line in seen), seen
    assert m["decode_path"] == "gather"
    assert m["decode_path_reason"] == reason


def test_worker_stats_at_tp():
    """A tp-2 worker's $STATS reply over the control plane: tp, rank,
    backend, window-graph mode, every rank's launches; its stream equals
    the JAX engine's."""
    run = _run("mqa-tp2")
    got = run["port"]["worker"]
    assert got["tokens"] == run["jax"]["worker"]
    stats = got["stats"]
    tp = stats["tp"]
    assert (tp["tp"], tp["rank"], tp["backend"]) == (2, 0, "gloo")
    assert tp["window_graphs"] == stats["graphs"]["mode"] == "off (cpu)"
    assert [r["rank"] for r in tp["ranks"]] == [0, 1]
    for r in tp["ranks"]:
        assert set(r["kernel_launches"]) == set(stats["kernel_launches"])
        assert r["all_reduces"] > 0 and r["backend"] == "gloo"
    assert stats["decode_path"] == "gather"
    assert stats["requests_admitted"] >= 1


# -- run.py --tp ---------------------------------------------------------------

def _run_py(*args, timeout=SPAWN_TIMEOUT_S):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(REPO))


def test_run_py_batch_tp2_equals_tp1(tmp_path):
    prompts = tmp_path / "p.jsonl"
    prompts.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in (
        "hello there, how are you", "tell me about the sea and the sky",
        "x" * 90)))
    outs = {}
    for tp in (1, 2):
        r = _run_py(f"in=batch:{prompts}", "out=native", "tiny", "--device",
                    "cpu", "--dtype", "float32", "--max-tokens", "10",
                    "--tp", str(tp))
        assert r.returncode == 0, r.stderr[-3000:]
        outs[tp] = [json.loads(x) for x in r.stdout.splitlines()
                    if x.startswith("{")]
    assert len(outs[1]) == 3
    assert outs[2] == outs[1]


def _visible_cards() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.mark.parametrize("args,named", [
    (("in=none", "out=native", "tiny", "--tp", "2"),
     f"needs 2 CUDA devices, {_visible_cards()} visible"),
    (("in=none", "out=echo", "tiny", "--tp", "2", "--device", "cpu"),
     "--tp needs out=native"),
    (("in=none", "out=native", "tiny", "--tp", "2", "--device", "cpu",
      "--quant", "int8"), "int8 weights"),
    (("in=none", "out=native", "tiny", "--tp", "2", "--device", "cpu",
      "--spec-decode", "ngram"), "speculative decoding"),
    (("in=none", "out=native", "tiny", "--tp", "2", "--device", "cpu",
      "--host-pages", "8"), "KV host / disk tiers"),
])
def test_run_py_refusals(args, named):
    r = _run_py(*args, timeout=120)
    assert r.returncode != 0
    assert named in r.stdout + r.stderr, (r.stdout + r.stderr)[-2000:]


def test_bootstrap_selftest_children_print_the_jax_line():
    """The JAX bootstrap's dry run as two port ranks on the CPU: every
    rank prints the JAX line with rank 0's tokens."""
    import re
    port = tlaunch_free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.parallel.bootstrap",
         "--selftest-child", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env) for r in range(2)]
    lines = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0
            lines += [x for x in out.splitlines() if x.startswith("MPDRY")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    pat = re.compile(r"MPDRY process=(\d) devices=2 mesh=dp1xtp2 "
                     r"tokens=(\[\d+, \d+, \d+, \d+\])$")
    got = sorted(pat.match(x).groups() for x in lines)
    assert [g[0] for g in got] == ["0", "1"]
    assert got[0][1] == got[1][1]


def tlaunch_free_port() -> int:
    from dynamo_tpu_torch.parallel.launch import free_port
    return free_port()
