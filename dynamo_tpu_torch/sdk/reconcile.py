"""`deploy --watch`: a minimal reconcile loop over rendered manifests.

Copied from dynamo_tpu/sdk/reconcile.py. The rendered manifests
(sdk/build.py) are the source of truth, and each tick closes three loops
with kubectl:

- spec change: each tick re-renders the graph's manifests; if the rendered
  bytes changed (graph/config edits, new image), re-apply.
- drift: observed Deployments are compared to desired (replicas, container
  image); scale-downs by hand, crashed rollouts, or deleted objects
  re-apply. `kubectl apply` is idempotent, so convergence is safe to
  repeat.
- status: each tick reports per-Deployment readiness (ready/desired
  replicas).

kubectl is injectable for tests (a recording stub).
"""
from __future__ import annotations

import hashlib
import json
import logging
import subprocess
import time
from typing import Dict, List, Optional

from dynamo_tpu_torch.sdk.build import render_manifests, write_manifests

log = logging.getLogger("dynamo_tpu_torch.reconcile")


class Reconciler:
    def __init__(self, graph: str, image: str, out_dir: str,
                 namespace: str = "default",
                 gpu_resource: str = "nvidia.com/gpu",
                 kubectl: str = "kubectl"):
        self.graph = graph
        self.image = image
        self.out_dir = out_dir
        self.namespace = namespace
        self.gpu_resource = gpu_resource
        self.kubectl = kubectl
        self._applied_hash: Optional[str] = None

    # -- kubectl ------------------------------------------------------------

    def _run(self, *args: str, input_text: Optional[str] = None) -> str:
        proc = subprocess.run(
            [self.kubectl, *args], input=input_text, capture_output=True,
            text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kubectl {' '.join(args)} failed rc={proc.returncode}: "
                f"{proc.stderr.strip()}")
        return proc.stdout

    # -- reconcile ----------------------------------------------------------

    def render(self) -> tuple:
        """Render + validate + write manifests; returns (manifests, path,
        content hash)."""
        manifests = render_manifests(self.graph, self.image,
                                     namespace=self.namespace,
                                     gpu_resource=self.gpu_resource)
        path = write_manifests(manifests, self.out_dir)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        return manifests, path, digest

    def observe(self) -> Dict[str, Dict]:
        """Deployment name -> {replicas, ready, image} as seen by the
        cluster (missing objects simply absent)."""
        out = self._run("get", "deployments", "-n", self.namespace,
                        "-o", "json")
        observed: Dict[str, Dict] = {}
        for item in json.loads(out).get("items", []):
            name = item["metadata"]["name"]
            spec = item.get("spec", {})
            containers = (spec.get("template", {}).get("spec", {})
                          .get("containers", []))
            observed[name] = {
                "replicas": spec.get("replicas", 0),
                "ready": item.get("status", {}).get("readyReplicas", 0),
                "image": containers[0]["image"] if containers else None,
            }
        return observed

    def _drifted(self, manifests: List[Dict],
                 observed: Dict[str, Dict]) -> List[str]:
        reasons = []
        for m in manifests:
            if m.get("kind") != "Deployment":
                continue
            name = m["metadata"]["name"]
            got = observed.get(name)
            if got is None:
                reasons.append(f"{name}: missing")
                continue
            want_replicas = m["spec"]["replicas"]
            want_image = m["spec"]["template"]["spec"][
                "containers"][0]["image"]
            if got["replicas"] != want_replicas:
                reasons.append(f"{name}: replicas {got['replicas']} != "
                               f"{want_replicas}")
            if got["image"] != want_image:
                reasons.append(f"{name}: image {got['image']} != "
                               f"{want_image}")
        return reasons

    def step(self) -> Dict:
        """One reconcile tick. Returns {"applied": bool, "reasons": [...],
        "status": {deployment: "ready/desired"}}."""
        manifests, path, digest = self.render()
        observed = self.observe()
        reasons: List[str] = []
        if digest != self._applied_hash:
            reasons.append("spec changed" if self._applied_hash
                           else "initial apply")
        else:
            reasons.extend(self._drifted(manifests, observed))
        applied = False
        if reasons:
            self._run("apply", "-f", path)
            self._applied_hash = digest
            applied = True
            log.info("applied %s (%s)", path, "; ".join(reasons))
            observed = self.observe()  # status reflects the applied state
        status = {
            name: f"{got['ready']}/{got['replicas']}"
            for name, got in observed.items()
        }
        return {"applied": applied, "reasons": reasons, "status": status}

    def watch(self, interval_s: float = 10.0,
              max_ticks: Optional[int] = None) -> None:
        """Reconcile until interrupted (or max_ticks, for tests)."""
        n = 0
        while max_ticks is None or n < max_ticks:
            try:
                out = self.step()
                if not out["applied"]:
                    log.info("in sync: %s", out["status"])
            except Exception:  # noqa: BLE001 — a flaky apiserver must not
                log.exception("reconcile tick failed")  # kill the loop
            n += 1
            if max_ticks is None or n < max_ticks:
                time.sleep(interval_s)
