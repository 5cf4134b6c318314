"""Local-vs-remote prefill decision.

Copied from dynamo_tpu/disagg/router.py: a prefill goes remote when its
uncached length exceeds the threshold and the prefill queue is not backed
up. Both limits reload live from the discovery store.
"""
from __future__ import annotations

import asyncio
import json
import logging

log = logging.getLogger("dynamo_tpu_torch.disagg")


def config_key(model: str) -> str:
    """Discovery-store key watched for live threshold updates."""
    return f"public/components/disagg_router/models/{model or 'default'}"


class DisaggregatedRouter:
    def __init__(self, max_local_prefill_length: int = 1000,
                 max_prefill_queue_size: int = 2, model: str = ""):
        self.max_local_prefill_length = max_local_prefill_length
        self.max_prefill_queue_size = max_prefill_queue_size
        self.model = model

    def prefill_remote(self, prefill_length: int, prefix_hit_length: int,
                       queue_depth: int) -> bool:
        long_enough = (prefill_length - prefix_hit_length
                       > self.max_local_prefill_length)
        queue_ok = queue_depth < self.max_prefill_queue_size
        return long_enough and queue_ok

    # -- live config reload ---------------------------------------------------

    async def watch_config(self, kv) -> None:
        """Follow threshold updates from the discovery store until
        cancelled."""
        snapshot, events = await kv.watch_prefix(config_key(self.model))
        for entry in snapshot:
            self._apply(entry.value)
        try:
            async for ev in events:
                if ev.kind == "put" and ev.value is not None:
                    self._apply(ev.value)
        finally:
            await events.aclose()

    def start_watching(self, kv) -> asyncio.Task:
        return asyncio.create_task(self.watch_config(kv))

    def _apply(self, raw: bytes) -> None:
        try:
            cfg = json.loads(raw)
        except (ValueError, TypeError):
            log.warning("ignoring malformed disagg config: %r", raw[:100])
            return
        if "max_local_prefill_length" in cfg:
            self.max_local_prefill_length = int(cfg["max_local_prefill_length"])
        if "max_prefill_queue_size" in cfg:
            self.max_prefill_queue_size = int(cfg["max_prefill_queue_size"])
        log.info("disagg thresholds: local<=%d queue<%d",
                 self.max_local_prefill_length, self.max_prefill_queue_size)
