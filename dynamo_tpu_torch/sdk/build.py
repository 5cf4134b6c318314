"""`build` + `deploy`: containerize a service graph, emit K8s manifests.

Copied from dynamo_tpu/sdk/build.py with the port's names. `build` writes a
self-contained bundle (a Dockerfile, the `dynamo_tpu_torch` package and the
graph's module tree, plus its config) that `docker build` turns into a
runnable image; `deploy` renders plain Kubernetes YAML: one Deployment per
service (the control plane on a PersistentVolumeClaim, the frontend, and
each graph service with its worker replica count and card request) plus
Services for the control plane and the HTTP frontend. `--watch` keeps the
rendered manifests applied (sdk/reconcile.py).

What differs from the JAX renderer, and nothing else: the modules are the
port's (`dynamo_tpu_torch.runtime.transports.server`,
`dynamo_tpu_torch.sdk.run_service`); the Dockerfile starts from a CUDA
PyTorch image with the CUDA toolkit (the kernels are built with nvcc at
first use) and installs numpy only; a service's `resources={"gpu": N}`
renders as an `nvidia.com/gpu` limit, where JAX renders `resources={"tpu":
N}` as `google.com/tpu`.

Usage:
  python -m dynamo_tpu_torch.sdk.build build \
      dynamo_tpu_torch.examples.disagg.graph:Frontend -o build/bundle
  python -m dynamo_tpu_torch.sdk.build deploy \
      dynamo_tpu_torch.examples.disagg.graph:Frontend -o build/k8s \
      --image dynamo-tpu-torch:latest [--namespace ns] \
      [--gpu-resource nvidia.com/gpu] [--watch [--interval S]]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List

from dynamo_tpu_torch.sdk.run_service import resolve
from dynamo_tpu_torch.sdk.service import collect_graph

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DOCKERFILE = """\
# Generated by dynamo_tpu_torch build
FROM pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel
WORKDIR /app
COPY dynamo_tpu_torch/ dynamo_tpu_torch/
COPY graph/ graph/
ENV PYTHONPATH=/app:/app/graph
# the base image carries torch and the CUDA toolkit (nvcc builds the
# kernels at first use, g++ the native host components); the serving
# stack needs numpy besides
RUN pip install --no-cache-dir numpy
ENTRYPOINT ["python", "-m", "dynamo_tpu_torch.sdk.serve"]
CMD [{cmd}]
"""


def build_bundle(graph: str, out_dir: str, config: str = "") -> str:
    """Emit a docker-buildable bundle for a service graph."""
    os.makedirs(out_dir, exist_ok=True)
    pkg_dst = os.path.join(out_dir, "dynamo_tpu_torch")
    if os.path.exists(pkg_dst):
        shutil.rmtree(pkg_dst)
    shutil.copytree(os.path.join(REPO_ROOT, "dynamo_tpu_torch"), pkg_dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    graph_dir = os.path.join(out_dir, "graph")
    os.makedirs(graph_dir, exist_ok=True)
    # copy the module tree containing the graph entry
    mod_name = graph.split(":")[0].split(".")[0]
    src = os.path.join(os.getcwd(), mod_name)
    if os.path.isdir(src):
        dst = os.path.join(graph_dir, mod_name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst,
                        ignore=shutil.ignore_patterns("__pycache__"))
    elif os.path.isfile(src + ".py"):
        shutil.copy(src + ".py", graph_dir)
    cmd_parts = [graph]
    if config:
        shutil.copy(config, os.path.join(out_dir, "graph", "config.yaml"))
        cmd_parts += ["-f", "graph/config.yaml"]
    cmd = ", ".join(json.dumps(p) for p in cmd_parts)
    df = os.path.join(out_dir, "Dockerfile")
    with open(df, "w") as f:
        f.write(DOCKERFILE.format(cmd=cmd))
    return df


# -- K8s manifests ------------------------------------------------------------

def _manifest(kind: str, name: str, spec: Dict, namespace: str) -> Dict:
    return {"apiVersion": "apps/v1" if kind == "Deployment" else "v1",
            "kind": kind,
            "metadata": {"name": name, "namespace": namespace,
                         "labels": {"app.kubernetes.io/part-of": "dynamo-tpu",
                                    "app": name}},
            "spec": spec}


def _deployment(name: str, image: str, args: List[str], replicas: int,
                namespace: str, env: Dict[str, str],
                gpu_resource: str = "", gpu_count: int = 0,
                ports: List[int] = ()) -> Dict:
    container = {
        "name": name,
        "image": image,
        "args": args,
        "env": [{"name": k, "value": v} for k, v in env.items()],
    }
    if ports:
        container["ports"] = [{"containerPort": p} for p in ports]
    if gpu_resource and gpu_count:
        container["resources"] = {
            "limits": {gpu_resource: str(gpu_count)}}
    return _manifest("Deployment", name, {
        "replicas": replicas,
        "selector": {"matchLabels": {"app": name}},
        "template": {
            "metadata": {"labels": {"app": name}},
            "spec": {"containers": [container]},
        },
    }, namespace)


def _service(name: str, port: int, namespace: str) -> Dict:
    return _manifest("Service", name, {
        "selector": {"app": name},
        "ports": [{"port": port, "targetPort": port}],
    }, namespace)


def render_manifests(graph: str, image: str, namespace: str = "default",
                     gpu_resource: str = "nvidia.com/gpu",
                     control_port: int = 6230,
                     http_port: int = 8080) -> List[Dict]:
    """One Deployment per graph service + the control plane + Services.

    Card counts come from each service's resources={"gpu": N}
    declaration."""
    entry = resolve(graph)
    specs = collect_graph(entry)
    coord_host = f"dynamo-control-plane.{namespace}.svc"
    cp = _deployment("dynamo-control-plane", image,
                     ["-m", "dynamo_tpu_torch.runtime.transports.server",
                      "--port", str(control_port),
                      "--data-dir", "/data"], 1, namespace, {},
                     ports=[control_port])
    # --data-dir is the durability feature: back it with a PVC so a pod
    # restart doesn't silently lose the journaled KV/queue state
    pod = cp["spec"]["template"]["spec"]
    pod["containers"][0]["volumeMounts"] = [
        {"name": "data", "mountPath": "/data"}]
    pod["volumes"] = [{"name": "data", "persistentVolumeClaim":
                       {"claimName": "dynamo-control-plane-data"}}]
    pvc = {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
           "metadata": {"name": "dynamo-control-plane-data",
                        "namespace": namespace,
                        "labels": {"app.kubernetes.io/part-of":
                                   "dynamo-tpu"}},
           "spec": {"accessModes": ["ReadWriteOnce"],
                    "resources": {"requests": {"storage": "1Gi"}}}}
    out: List[Dict] = [
        pvc, cp,
        _service("dynamo-control-plane", control_port, namespace),
    ]
    for spec in specs:
        name = f"dynamo-{spec.name.lower()}"
        gpu = int(spec.resources.get("gpu", 0))
        cls_path = f"{spec.cls.__module__}:{spec.cls.__name__}"
        dep = _deployment(
            name, image,
            ["-m", "dynamo_tpu_torch.sdk.run_service", cls_path,
             "--control-host", coord_host,
             "--control-port", str(control_port)],
            spec.workers, namespace,
            {"DYN_COORD_ADDR": f"{coord_host}:{control_port}"},
            gpu_resource=gpu_resource, gpu_count=gpu,
            ports=[http_port] if spec.name == "Frontend" else ())
        out.append(dep)
        if spec.name == "Frontend":
            out.append(_service(name, http_port, namespace))
    # every container runs plain `python -m ...` (the image ENTRYPOINT is
    # the local-serve convenience; k8s pods run one process per service)
    for m in out:
        if m["kind"] == "Deployment":
            m["spec"]["template"]["spec"]["containers"][0]["command"] = [
                "python"]
    return out


def _to_yaml(obj, indent: int = 0) -> str:
    """Minimal YAML emitter (no external deps; manifests are plain data)."""
    pad = "  " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}"
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        lines = []
        for it in obj:
            if isinstance(it, (dict, list)) and it:
                body = _to_yaml(it, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}" +
                             (f"\n{rest}" if rest else ""))
            else:
                lines.append(f"{pad}- {_scalar(it)}")
        return "\n".join(lines)
    return pad + _scalar(obj)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return str(v)
    s = str(v)

    def yaml_ambiguous(x: str) -> bool:
        # strings YAML would parse as a non-string (Container.args is
        # []string — an unquoted "6230" breaks kubectl apply)
        if x.lower() in ("true", "false", "null", "~", "yes", "no",
                         "on", "off"):
            return True
        try:
            float(x)
            return True
        except ValueError:
            return False

    if s == "" or yaml_ambiguous(s) \
            or any(c in s for c in ":{}[]#&*!|>'\"%@`") \
            or s != s.strip():
        return json.dumps(s)
    return s


def validate_manifests(manifests: List[Dict]) -> None:
    """Structural schema check of rendered manifests.

    Catches render bugs before kubectl does: every object needs
    apiVersion/kind/metadata.name; a Deployment's selector must match its
    pod template labels (the classic silent-orphan mistake), containers
    need image+name, and resource quantities must be int-or-string; a
    Service needs a selector and numeric ports. Raises ValueError naming
    the object and field."""
    def need(obj, path_, ctx):
        node = obj
        for part in path_.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"{ctx}: missing {path_}")
            node = node[part]
        return node

    for m in manifests:
        kind = m.get("kind") or "?"
        name = (m.get("metadata") or {}).get("name") or "?"
        ctx = f"{kind}/{name}"
        need(m, "apiVersion", ctx)
        need(m, "kind", ctx)
        need(m, "metadata.name", ctx)
        if kind == "Deployment":
            sel = need(m, "spec.selector.matchLabels", ctx)
            labels = need(m, "spec.template.metadata.labels", ctx)
            if not sel or any(labels.get(k) != v for k, v in sel.items()):
                raise ValueError(
                    f"{ctx}: selector {sel} does not match template "
                    f"labels {labels}")
            if not isinstance(need(m, "spec.replicas", ctx), int):
                raise ValueError(f"{ctx}: spec.replicas must be an int")
            containers = need(m, "spec.template.spec.containers", ctx)
            if not containers:
                raise ValueError(f"{ctx}: no containers")
            for c in containers:
                if not c.get("name") or not c.get("image"):
                    raise ValueError(f"{ctx}: container needs name+image")
                for group in (c.get("resources") or {}).values():
                    for res, qty in group.items():
                        if not isinstance(qty, (int, str)):
                            raise ValueError(
                                f"{ctx}: resource {res}={qty!r} must be "
                                f"int or quantity string")
        elif kind == "Service":
            if not need(m, "spec.selector", ctx):
                raise ValueError(f"{ctx}: empty service selector")
            for p in need(m, "spec.ports", ctx):
                if not isinstance(p.get("port"), int):
                    raise ValueError(f"{ctx}: service port must be int")


def write_manifests(manifests: List[Dict], out_dir: str) -> str:
    validate_manifests(manifests)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "dynamo-tpu.yaml")
    with open(path, "w") as f:
        f.write("\n---\n".join(_to_yaml(m) for m in manifests) + "\n")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dynamo_tpu_torch build/deploy")
    ap.add_argument("action", choices=["build", "deploy"])
    ap.add_argument("graph", help="module.path:EntryService")
    ap.add_argument("-f", "--config", default="")
    ap.add_argument("-o", "--out", default="build")
    ap.add_argument("--image", default="dynamo-tpu-torch:latest")
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--gpu-resource", default="nvidia.com/gpu")
    ap.add_argument("--watch", action="store_true",
                    help="reconcile loop: apply manifests, then keep "
                         "re-applying on spec change or cluster drift "
                         "(sdk/reconcile.py)")
    ap.add_argument("--interval", type=float, default=10.0,
                    help="--watch tick interval seconds")
    args = ap.parse_args(argv)
    if args.action == "build":
        df = build_bundle(args.graph, args.out, args.config)
        print(f"bundle ready: docker build -t {args.image} "
              f"{os.path.dirname(df)}")
    elif args.watch:
        from dynamo_tpu_torch.utils.logconfig import configure_logging
        configure_logging()
        from dynamo_tpu_torch.sdk.reconcile import Reconciler
        Reconciler(args.graph, args.image, args.out,
                   namespace=args.namespace,
                   gpu_resource=args.gpu_resource).watch(args.interval)
    else:
        manifests = render_manifests(args.graph, args.image,
                                     namespace=args.namespace,
                                     gpu_resource=args.gpu_resource)
        path = write_manifests(manifests, args.out)
        print(f"manifests ready: kubectl apply -f {path}")


if __name__ == "__main__":
    main()
