"""The port's deployment tooling against the JAX package's: the K8s bundle
and manifests (dynamo_tpu_torch/sdk/build.py), the reconcile loop
(sdk/reconcile.py) and llmctl.

- `render_manifests` of each package's disaggregated example graph, and of
  a graph that asks for 4 cards, are the same manifests once the
  differences ROADMAP §C explains are mapped back: the port's module names
  (`dynamo_tpu_torch.*`, its example graph inside the package) and its
  accelerator request (`resources={"gpu": N}` as `nvidia.com/gpu`, where
  JAX renders `resources={"tpu": N}` as `google.com/tpu`). The YAML text
  maps the same way. `validate_manifests` refuses the same broken renders.
- `build_bundle` writes the port's package, the graph's module tree and a
  Dockerfile that runs the port's supervisor.
- The reconciler over a recording kubectl stub: the same command sequence
  as JAX's through an initial apply, an in-sync tick, a hand scale-down
  and a deleted Deployment.
- llmctl `add` / `list` / `remove` write, print and delete the same
  registry keys and values as JAX's, each against its own package's
  in-memory plane; the port's frontend discovery reads what it writes.
"""
import asyncio
import copy
import json
import os
import stat
import sys

import pytest

from dynamo_tpu.sdk import build as jbuild
from dynamo_tpu.sdk import reconcile as jrec
from dynamo_tpu_torch.sdk import build as tbuild
from dynamo_tpu_torch.sdk import reconcile as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JGRAPH = "examples.disagg.graph:Frontend"
TGRAPH = "dynamo_tpu_torch.examples.disagg.graph:Frontend"


def _to_jax_names(obj):
    """The port's rendering with the explained differences mapped back to
    JAX's names."""
    if isinstance(obj, dict):
        return {("google.com/tpu" if k == "nvidia.com/gpu" else k):
                _to_jax_names(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_jax_names(v) for v in obj]
    if isinstance(obj, str):
        return (obj.replace("dynamo_tpu_torch.examples.", "examples.")
                .replace("dynamo_tpu_torch.", "dynamo_tpu."))
    return obj


@pytest.fixture
def at_repo(monkeypatch):
    monkeypatch.chdir(REPO)
    if REPO not in sys.path:
        monkeypatch.syspath_prepend(REPO)


@pytest.mark.parametrize("namespace", ["default", "prod"])
def test_render_manifests_equal_jax(at_repo, tmp_path, namespace):
    want = jbuild.render_manifests(JGRAPH, "img:v1", namespace=namespace)
    got = tbuild.render_manifests(TGRAPH, "img:v1", namespace=namespace)
    assert _to_jax_names(got) == want
    kinds = [(m["kind"], m["metadata"]["name"]) for m in got]
    assert ("Deployment", "dynamo-decodeworker") in kinds
    assert ("Service", "dynamo-frontend") in kinds
    args = [m["spec"]["template"]["spec"]["containers"][0]["args"]
            for m in got if m["kind"] == "Deployment"]
    assert ["-m", "dynamo_tpu_torch.runtime.transports.server"] == \
        args[0][:2]
    assert all(a[1] == "dynamo_tpu_torch.sdk.run_service" for a in args[1:])
    # the YAML text, the same mapped back
    jtext = open(jbuild.write_manifests(want, str(tmp_path / "j"))).read()
    ttext = open(tbuild.write_manifests(got, str(tmp_path / "t"))).read()
    assert (ttext.replace("dynamo_tpu_torch.examples.", "examples.")
            .replace("dynamo_tpu_torch.", "dynamo_tpu.")) == jtext


def test_manifest_card_resources_equal_jax(monkeypatch):
    """A service asking for 4 cards and 2 workers: the port's
    resources={"gpu": 4} renders an nvidia.com/gpu limit where JAX's
    resources={"tpu": 4} renders google.com/tpu; nothing else differs."""
    mod = sys.modules[__name__]
    rendered = {}
    for name, svc_mod, key, build in (
            ("jax", "dynamo_tpu.sdk.service", "tpu", jbuild),
            ("torch", "dynamo_tpu_torch.sdk.service", "gpu", tbuild)):
        service = __import__(svc_mod, fromlist=["service"]).service

        @service(name="CardWorker", namespace="ns", component="w",
                 resources={key: 4}, workers=2)
        class CardWorker:
            pass
        monkeypatch.setattr(mod, "CardWorker", CardWorker, raising=False)
        rendered[name] = build.render_manifests(
            f"{__name__}:CardWorker", "img")
    dep = next(m for m in rendered["torch"]
               if m["metadata"]["name"] == "dynamo-cardworker")
    c = dep["spec"]["template"]["spec"]["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "4"}
    assert dep["spec"]["replicas"] == 2
    assert _to_jax_names(rendered["torch"]) == rendered["jax"]


GOOD = {
    "apiVersion": "apps/v1", "kind": "Deployment",
    "metadata": {"name": "d", "namespace": "ns"},
    "spec": {"replicas": 1,
             "selector": {"matchLabels": {"app": "d"}},
             "template": {
                 "metadata": {"labels": {"app": "d"}},
                 "spec": {"containers": [
                     {"name": "c", "image": "img",
                      "resources": {"limits": {"cpu": "1"}}}]}}},
}


def _broken(kind):
    m = copy.deepcopy(GOOD)
    c = m["spec"]["template"]["spec"]["containers"][0]
    if kind == "selector":
        m["spec"]["selector"]["matchLabels"]["app"] = "other"
    elif kind == "image":
        del c["image"]
    elif kind == "quantity":
        c["resources"] = {"limits": {"nvidia.com/gpu": 4.5}}
    elif kind == "replicas":
        m["spec"]["replicas"] = "1"
    elif kind == "containers":
        m["spec"]["template"]["spec"]["containers"] = []
    elif kind == "apiVersion":
        m = {"kind": "Service", "metadata": {"name": "s"}}
    elif kind == "service-selector":
        m = {"apiVersion": "v1", "kind": "Service",
             "metadata": {"name": "s"},
             "spec": {"selector": {}, "ports": [{"port": 1}]}}
    elif kind == "service-port":
        m = {"apiVersion": "v1", "kind": "Service",
             "metadata": {"name": "s"},
             "spec": {"selector": {"app": "s"}, "ports": [{"port": "1"}]}}
    return m


@pytest.mark.parametrize("kind", [
    "selector", "image", "quantity", "replicas", "containers",
    "apiVersion", "service-selector", "service-port"])
def test_validate_manifests_catches_the_same_renders(kind):
    tbuild.validate_manifests([GOOD])
    errs = []
    for mod in (jbuild, tbuild):
        with pytest.raises(ValueError) as e:
            mod.validate_manifests([_broken(kind)])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_build_bundle(at_repo, tmp_path):
    out = str(tmp_path / "bundle")
    df = tbuild.build_bundle(TGRAPH, out)
    dockerfile = open(df).read()
    assert "dynamo_tpu_torch.sdk.serve" in dockerfile
    assert "jax" not in dockerfile.lower()
    assert f'CMD ["{TGRAPH}"]' in dockerfile
    assert os.path.exists(os.path.join(out, "dynamo_tpu_torch", "engine",
                                       "engine.py"))
    assert not os.path.exists(os.path.join(out, "dynamo_tpu"))
    assert os.path.exists(os.path.join(out, "graph", "dynamo_tpu_torch",
                                       "examples", "disagg", "graph.py"))
    cfg = os.path.join(REPO, "dynamo_tpu_torch", "examples", "disagg",
                       "config.cpu.json")
    df = tbuild.build_bundle(TGRAPH, str(tmp_path / "b2"), cfg)
    assert '"-f", "graph/config.yaml"' in open(df).read()


def _stub_cluster(tmp_path, deployments):
    state = tmp_path / "cluster.json"
    calls = tmp_path / "calls.log"
    stub = tmp_path / "kubectl"

    def cluster_state(scale_override=None, drop=None):
        items = []
        for m in deployments:
            name = m["metadata"]["name"]
            if name == drop:
                continue
            reps = (scale_override or {}).get(name, m["spec"]["replicas"])
            items.append({"metadata": {"name": name},
                          "spec": {"replicas": reps,
                                   "template": m["spec"]["template"]},
                          "status": {"readyReplicas": reps}})
        state.write_text(json.dumps({"items": items}))

    stub.write_text(f"""#!/bin/sh
echo "$@" >> {calls}
case "$1" in
  get) cat {state} ;;
  apply) : ;;
esac
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return cluster_state, calls, str(stub)


def _reconcile(tmp_path, rec_mod, build_mod, graph):
    desired = build_mod.render_manifests(graph, "img:v1")
    deployments = [m for m in desired if m["kind"] == "Deployment"]
    cluster_state, calls, stub = _stub_cluster(tmp_path, deployments)
    out_dir = str(tmp_path / "k8s")
    rec = rec_mod.Reconciler(graph, "img:v1", out_dir, kubectl=stub)
    cluster_state()
    ticks = [rec.step(), rec.step()]
    victim = deployments[-1]["metadata"]["name"]
    cluster_state(scale_override={victim: 0})
    ticks.append(rec.step())
    cluster_state(drop=victim)
    ticks.append(rec.step())
    seq = [ln.replace(out_dir, "<out>")
           for ln in calls.read_text().splitlines()]
    return ticks, seq


def test_reconcile_commands_equal_jax(at_repo, tmp_path):
    """The same kubectl command sequence and tick verdicts as JAX's."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jt, jseq = _reconcile(tmp_path / "j", jrec, jbuild, JGRAPH)
    tt, tseq = _reconcile(tmp_path / "t", trec, tbuild, TGRAPH)
    assert tseq == jseq
    assert tt == jt
    assert [t["applied"] for t in tt] == [True, False, True, True]
    assert tt[0]["reasons"] == ["initial apply"]
    assert any("replicas 0" in r for r in tt[2]["reasons"])
    assert any("missing" in r for r in tt[3]["reasons"])
    assert sum(ln.startswith("apply") for ln in tseq) == 3


def test_reconcile_spec_change_and_failed_tick(at_repo, tmp_path):
    """A new image re-renders and re-applies ("spec changed"); a kubectl
    failure is logged and the watch loop goes on."""
    desired = tbuild.render_manifests(TGRAPH, "img:v1")
    deps = [m for m in desired if m["kind"] == "Deployment"]
    cluster_state, calls, stub = _stub_cluster(tmp_path, deps)
    rec = trec.Reconciler(TGRAPH, "img:v1", str(tmp_path / "k8s"),
                          kubectl=stub)
    cluster_state()
    assert rec.step()["reasons"] == ["initial apply"]
    rec.image = "img:v2"
    assert rec.step()["reasons"] == ["spec changed"]
    bad = trec.Reconciler(TGRAPH, "img:v1", str(tmp_path / "k2"),
                          kubectl=str(tmp_path / "missing-kubectl"))
    bad.watch(interval_s=0.0, max_ticks=2)   # logs, does not raise


# -- llmctl ------------------------------------------------------------------------

def _llmctl_run(pkg, argvs, monkeypatch, capsys):
    """Each argv through the package's llmctl against one in-memory plane
    of its own; returns (printed lines, the registry's keys -> values)."""
    if pkg == "jax":
        from dynamo_tpu import llmctl
        from dynamo_tpu.runtime.distributed import DistributedRuntime
        from dynamo_tpu.runtime.transports.memory import MemoryPlane
    else:
        from dynamo_tpu_torch import llmctl
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
        from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane

    async def main():
        plane = MemoryPlane()

        async def connect(*_a, **_k):
            return await DistributedRuntime.create_local(plane)
        monkeypatch.setattr(DistributedRuntime, "connect", connect)
        printed = []
        for argv in argvs:
            if pkg == "jax":
                monkeypatch.setattr(sys, "argv", ["llmctl", *argv])
                await llmctl.amain()
            else:
                await llmctl.amain(argv)
            printed.append(capsys.readouterr().out.strip().splitlines())
        rt = await DistributedRuntime.create_local(plane)
        kv = {e.key: json.loads(e.value)
              for e in await rt.kv.get_prefix("models/")}
        await rt.shutdown()
        return printed, kv
    return asyncio.run(main())


LLMCTL_STEPS = [
    ["list"],
    ["add", "alias", "dynamo.llm.generate", "--arch", "llama3-8b",
     "--kv-routed"],
    ["add", "done", "ns.comp.ep", "--arch", "tiny", "--model-type", "both"],
    ["list"],
    ["remove", "done"],
    ["list"],
]


def test_llmctl_writes_the_keys_jax_writes(monkeypatch, capsys):
    jout, jkv = _llmctl_run("jax", LLMCTL_STEPS, monkeypatch, capsys)
    tout, tkv = _llmctl_run("torch", LLMCTL_STEPS, monkeypatch, capsys)
    assert tout == jout
    assert tkv == jkv
    assert list(tkv) == ["models/chat/alias"]
    payload = tkv["models/chat/alias"]
    assert payload["card"]["arch"] == "llama3-8b"
    assert (payload["namespace"], payload["component"],
            payload["endpoint"], payload["kv_routed"]) == \
        ("dynamo", "llm", "generate", True)
    assert tout[0] == ["(no models registered)"]
    assert tout[3][0].startswith("both/done\tns.comp.ep")
    # the port's discovery reads the card it wrote
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    card = ModelDeploymentCard.from_dict(payload["card"])
    assert card.model_config().name == "llama3-8b"


@pytest.mark.parametrize("arch", ["tiny", "tiny-moe", "tiny-vl", "llama3-1b",
                                  "llama3-8b", "llama3-70b", "mixtral-8x7b",
                                  "qwen2-vl-7b"])
def test_llmctl_arch_takes_every_registry_model(monkeypatch, capsys, arch):
    from dynamo_tpu_torch.engine.config import _CONFIGS
    assert arch in _CONFIGS
    _, kv = _llmctl_run("torch", [["add", "m", "a.b.c", "--arch", arch]],
                        monkeypatch, capsys)
    assert kv["models/chat/m"]["card"]["arch"] == arch


def test_llmctl_refuses_bad_input(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        _llmctl_run("torch", [["add", "m", "a.b.c", "--arch", "nope"]],
                    monkeypatch, capsys)
    with pytest.raises(SystemExit, match="ns.component.endpoint"):
        _llmctl_run("torch", [["add", "m", "nodots"]], monkeypatch, capsys)
