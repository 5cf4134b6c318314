"""Model registry + frontend discovery watcher.

Copied from dynamo_tpu/frontend/discovery.py: `register_model` (:29) writes
the model -> endpoint mapping under `models/{type}/{name}`,
`unregister_model` removes it, `list_registered_models` (:58) reads them
all (llmctl's `list`), and `ModelWatcher` (:68-230) watches the
registry and builds one `RemotePipeline` per registered model (a runtime
Client plus, for a KV-routed model when the watcher has a router factory,
a KvRouter), rebinding it on a re-registration and removing it on a
delete. Watch events apply in per-tick batches coalesced per key; a
watch-stream failure resumes with backoff and a snapshot resync.

Each pipeline dispatches through a ReliableClient of its own
(frontend/reliability.py, :195-209) that shares the watcher's policy and
metrics, so the migrations, retries and breaker events of every model
land on one /metrics; one snapshot publisher per namespace puts those
counters on the event plane under `frontend-<worker id>`.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional

from dynamo_tpu_torch.frontend.reliability import ReliableClient
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.pipeline import RemotePipeline
from dynamo_tpu_torch.runtime.backoff import Backoff

log = logging.getLogger("dynamo_tpu_torch.discovery")

MODELS_PREFIX = "models/"


def model_key(model_type: str, name: str) -> str:
    return f"{MODELS_PREFIX}{model_type}/{name}"


async def register_model(kv, name: str, namespace: str, component: str,
                         card: ModelDeploymentCard,
                         endpoint: str = "generate",
                         model_type: str = "chat",
                         kv_routed: bool = False) -> None:
    """Write the model -> endpoint mapping."""
    payload = {
        "name": name,
        "namespace": namespace,
        "component": component,
        "endpoint": endpoint,
        "model_type": model_type,
        "kv_routed": kv_routed,
        "card": card.to_dict(),
    }
    await kv.put(model_key(model_type, name), json.dumps(payload).encode())


async def unregister_model(kv, name: str, model_type: str = "chat") -> None:
    if model_type == "both":
        # a model may have been registered under any type key
        for t in ("both", "chat", "completion"):
            await kv.delete(model_key(t, name))
    else:
        await kv.delete(model_key(model_type, name))


async def list_registered_models(kv) -> Dict[str, dict]:
    """Every registry entry: "{type}/{name}" -> its payload."""
    out = {}
    for e in await kv.get_prefix(MODELS_PREFIX):
        try:
            out[e.key[len(MODELS_PREFIX):]] = json.loads(e.value)
        except (ValueError, TypeError):
            continue
    return out


class ModelWatcher:
    """Watches the model registry and (de)registers pipelines live."""

    def __init__(self, runtime, model_manager, make_router=None,
                 reliability_metrics=None, reliability_policy=None):
        """make_router: optional async (component, client, card) ->
        KvRouter enabling KV-aware routing for models registered with
        kv_routed=True. reliability_metrics / reliability_policy: shared
        by every pipeline's ReliableClient (HttpService.reliability is
        the service's metrics)."""
        self.runtime = runtime
        self.models = model_manager
        self.make_router = make_router
        self.reliability_metrics = reliability_metrics
        self.reliability_policy = reliability_policy
        # one reliability-snapshot publisher task per namespace served
        self._rel_publishers: Dict[str, asyncio.Task] = {}
        self._task: Optional[asyncio.Task] = None
        self._owned: Dict[str, tuple] = {}  # key -> (client, router)
        self._values: Dict[str, bytes] = {}  # key -> last applied payload
        self.pipelines: Dict[str, RemotePipeline] = {}  # key -> pipeline

    async def start(self) -> "ModelWatcher":
        snapshot, stream = await self.runtime.kv.watch_prefix(MODELS_PREFIX)
        for e in snapshot:
            await self._on_put(e.key, e.value)
        self._task = asyncio.create_task(self._pump(stream))
        return self

    async def _pump(self, stream) -> None:
        """Registry watch pump: per-tick batched application coalesced
        per key, and on a watch-stream failure a resume with bounded
        backoff + jitter and a full snapshot resync."""
        backoff = Backoff(base_s=0.05, max_s=2.0, stable_reset_s=10.0)
        try:
            while True:
                try:
                    batch = await stream.next_batch()
                    final = {}
                    for ev in batch:
                        final[ev.key] = ev
                    for ev in final.values():
                        await self._dispatch(ev.kind, ev.key, ev.value)
                    backoff.reset()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the pump must outlive it
                    log.warning("model watch stream failed; resuming with "
                                "resync", exc_info=True)
                    try:
                        await stream.aclose()
                    except Exception:  # dynalint: swallow-ok=best-effort-close
                        pass
                    await backoff.sleep()
                    try:
                        snapshot, stream = await self.runtime.kv.watch_prefix(
                            MODELS_PREFIX)
                    except Exception:  # dynalint: swallow-ok=retried-next-round
                        log.warning("model watch re-establish failed",
                                    exc_info=True)
                        continue
                    await self._resync(snapshot)
        finally:
            try:
                await stream.aclose()
            except Exception:  # dynalint: swallow-ok=teardown-best-effort
                pass

    async def _dispatch(self, kind: str, key: str,
                        value: Optional[bytes]) -> None:
        try:
            if kind == "put":
                await self._on_put(key, value)
            else:
                await self._on_delete(key)
        except Exception:  # dynalint: swallow-ok=must-outlive-a-bad-event
            log.exception("model watch event failed: %s", key)

    async def _resync(self, snapshot) -> None:
        """Reconcile the registry after a watch gap; unchanged keys (same
        payload bytes) are skipped."""
        seen = set()
        for e in snapshot:
            seen.add(e.key)
            if self._values.get(e.key) == e.value:
                continue
            await self._dispatch("put", e.key, e.value)
        for key in [k for k in self._owned if k not in seen]:
            await self._dispatch("delete", key, None)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
        for task in self._rel_publishers.values():
            task.cancel()
        self._rel_publishers.clear()
        for client, router in self._owned.values():
            if router is not None:
                await router.stop()
            await client.stop()
        self._owned.clear()
        self.pipelines.clear()

    async def _on_put(self, key: str, value: bytes) -> None:
        prev = self._owned.pop(key, None)
        if prev is not None:  # re-registration: stop the old client/router
            client, router = prev
            if router is not None:
                await router.stop()
            await client.stop()
        info = json.loads(value)
        card = ModelDeploymentCard.from_dict(info["card"])
        comp = self.runtime.namespace(info["namespace"]).component(
            info["component"])
        client = comp.endpoint(info["endpoint"]).client()
        await client.start()
        router = None
        if info.get("kv_routed") and self.make_router is not None:
            router = await self.make_router(comp, client, card)
        reliable = ReliableClient(client, policy=self.reliability_policy,
                                  router=router,
                                  metrics=self.reliability_metrics)
        ns = info["namespace"]
        if self.reliability_metrics is not None \
                and ns not in self._rel_publishers:
            # the component carries this frontend's worker id: frontends
            # sharing a namespace must not overwrite each other's snapshot
            self._rel_publishers[ns] = \
                self.reliability_metrics.start_publishing(
                    self.runtime.namespace(ns).component(
                        f"frontend-{self.runtime.worker_id}"))
        pipeline = RemotePipeline(card, client, router=router,
                                  reliability=reliable)
        self.models.add(info["name"], pipeline, info.get("model_type", "chat"))
        self._owned[key] = (client, router)
        self._values[key] = value
        self.pipelines[key] = pipeline
        log.info("model registered: %s -> %s/%s/%s%s", info["name"],
                 info["namespace"], info["component"], info["endpoint"],
                 " [kv-routed]" if router else "")

    async def _on_delete(self, key: str) -> None:
        parts = key[len(MODELS_PREFIX):].split("/", 1)
        if len(parts) == 2:
            # only deregister the deleted key's model_type: the same name
            # may still be registered under another type (its own key)
            self.models.remove(parts[1], model_type=parts[0])
        owned = self._owned.pop(key, None)
        self._values.pop(key, None)
        self.pipelines.pop(key, None)
        if owned:
            client, router = owned
            if router is not None:
                await router.stop()
            await client.stop()
        log.info("model removed: %s", key)
