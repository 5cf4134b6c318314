"""Per-service card assignment.

Copied from dynamo_tpu/sdk/allocator.py, with CUDA in place of the TPU:
the supervisor hands each service worker that asks for cards
(`resources={"gpu": n}`) a disjoint set through CUDA_VISIBLE_DEVICES. A
service that asks for none shares card 0 (a deployment on one card runs
its prefill and decode workers side by side there) and runs on the CPU
when the machine has no card.
"""
from __future__ import annotations

from typing import Dict, List


class CardAllocator:
    def __init__(self, total_cards: int):
        self.total = total_cards
        self._next = 0

    def assign(self, n: int) -> List[int]:
        if self._next + n > self.total:
            raise RuntimeError(
                f"not enough cards: need {n}, "
                f"{self.total - self._next} of {self.total} left")
        cards = list(range(self._next, self._next + n))
        self._next += n
        return cards

    def env_for(self, resources: Dict) -> Dict[str, str]:
        n = int(resources.get("gpu", 0))
        if n <= 0:
            return {}
        return {"CUDA_VISIBLE_DEVICES": ",".join(
            str(c) for c in self.assign(n))}
