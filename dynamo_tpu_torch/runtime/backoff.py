"""Seeded bounded backoff with jitter + flap hysteresis.

Copied whole from dynamo_tpu/runtime/backoff.py.

Every control-plane retry loop (watch-pump resume, re-registration after
a lease loss, breaker re-probe) needs the same three properties, and a
1000-worker storm punishes any loop missing one of them:

- **bounded exponential growth**: a persistent outage must not tighten
  into a busy-loop against the discovery store;
- **jitter**: when hundreds of workers lose their leases in one burst,
  un-jittered backoff re-synchronizes them into repeated thundering
  herds — every retry wave lands on the store at the same instant
  (dynalint R12 enforces that the loops in-tree carry this);
- **flap hysteresis**: a worker that keeps cycling register → die →
  register within a short window should wait LONGER each cycle, but one
  that has been stable for a while earns a fresh (short) first delay.
  ``stable_reset_s`` implements this: the attempt counter only rewinds
  after the loop has gone that long without asking for a delay.

Seeded (`rng`) so the sim harness's storms are replayable: the same
seed yields the same jitter sequence.
"""
from __future__ import annotations

import asyncio
import random
import time
from typing import Optional


class Backoff:
    """Delay source for one retry loop. Not thread-safe (asyncio-owned).

    ``next_delay()`` grows ``base_s * 2**k`` capped at ``max_s``, with
    multiplicative jitter in ``[1, 1+jitter]`` (the reliability layer's
    shape); ``reset()`` rewinds after a confirmed success. Hysteresis:
    if ``stable_reset_s`` elapsed since the last ``next_delay()`` call,
    the counter rewinds on its own — a flap burst keeps growing delays,
    a stable stretch forgives them.
    """

    def __init__(self, base_s: float = 0.05, max_s: float = 5.0,
                 jitter: float = 0.5, stable_reset_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self.base_s = base_s
        self.max_s = max_s
        self.jitter = jitter
        self.stable_reset_s = stable_reset_s
        self._rng = rng or random.Random()
        self._attempts = 0
        self._last_ask: Optional[float] = None

    @property
    def attempts(self) -> int:
        return self._attempts

    def next_delay(self) -> float:
        now = time.monotonic()
        if (self._last_ask is not None and self.stable_reset_s > 0
                and now - self._last_ask > self.stable_reset_s):
            self._attempts = 0
        self._last_ask = now
        delay = min(self.max_s, self.base_s * (2 ** self._attempts))
        self._attempts += 1
        return delay * (1.0 + self.jitter * self._rng.random())

    async def sleep(self) -> float:
        delay = self.next_delay()
        await asyncio.sleep(delay)
        return delay

    def reset(self) -> None:
        self._attempts = 0


def jittered(delay_s: float, jitter: float = 0.5,
             rng: Optional[random.Random] = None) -> float:
    """One-shot jittered delay (re-registration staggering: N workers
    restarting after a storm must not stampede discovery in one tick)."""
    r = rng or random
    return delay_s * (1.0 + jitter * r.random())
