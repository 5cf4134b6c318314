"""The port's native C API (dynamo_tpu_torch/native/capi.cpp, capi_py.py):
a C++ worker publishing KV events into a live port control plane, received
by the port's KV router.

- `dyn_tokens_hash` equals engine/kv_cache.tokens_hash (keyed BLAKE2b-64
  over little-endian int32 tokens, written out in the C++ source) on
  seeded token lists of length 0, 1, 63, 64 and 4096.
- Stored and Removed events published through the C API over TCP reach
  the port's control-plane server and decode to the events the Python
  publisher would send; in the KvIndexer the stored pages give the native
  worker the prompt's overlap, and the removal takes it back to 0.
- An uninitialised call fails fast; a partial page is refused while
  connected.
The JAX twin hashes with xxh3 (ROADMAP §C); the wire and ABI are the same.
"""
import asyncio

import numpy as np
import pytest

from dynamo_tpu_torch.engine.kv_cache import page_hash, tokens_hash
from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheRemoveData, KvCacheStoreData, RouterEvent,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.server import ControlPlaneServer


@pytest.fixture(scope="module")
def capi():
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.native.capi_py import CApi
    api = CApi()
    assert native.library_path("capi").exists()
    return api


@pytest.mark.parametrize("n", [0, 1, 63, 64, 4096])
def test_tokens_hash_matches_python(capi, n):
    rng = np.random.default_rng(n + 1)
    for toks in (rng.integers(0, 2**31 - 1, n).tolist(),
                 rng.integers(0, 128256, n).tolist()):
        assert capi.tokens_hash(toks) == tokens_hash(toks), n


def _chain(tokens, page):
    """[(page hash, page tokens)] of the full pages, chained as the
    engine's allocator chains them."""
    out, parent = [], 0
    for i in range(len(tokens) // page):
        toks = tokens[i * page:(i + 1) * page]
        parent = page_hash(parent, toks)
        out.append((parent, toks))
    return out


def test_publish_into_the_port_indexer_end_to_end(capi, tmp_path):
    from dynamo_tpu_torch.kv_router.indexer import KvIndexer

    page = 16
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 32000, 5 * page + 7).tolist()
    blocks = _chain(prompt, page)
    many = [(0xbeef0000 + i, [i] * page) for i in range(20)]

    async def main():
        server = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "cp")).start()
        try:
            rt = await DistributedRuntime.connect(
                "127.0.0.1", server.port, "pysub")
            comp = rt.namespace("ns").component("engine")
            sub = await comp.subscribe("kv_events")
            indexer = KvIndexer(page)

            def native_calls():
                capi.init("ns", "engine", "w-native", page,
                          "127.0.0.1", server.port)
                capi.publish_stored(1, None, blocks[:2])
                capi.publish_stored(2, blocks[1][0], blocks[2:])
                try:   # refused at the ABI edge while connected
                    capi.publish_stored(9, None, [(1, [1, 2, 3])])
                except IOError:
                    pass
                else:
                    raise AssertionError("a partial page was not refused")
                # >15 blocks: msgpack array16, a >255-byte payload: bin16
                capi.publish_stored(3, None, many)

            def native_remove():
                capi.publish_removed(4, [bh for bh, _ in blocks])
                capi.publish_removed(5, [bh for bh, _ in many])
                capi.shutdown()

            events = []

            async def drain(n):
                async for _subj, payload in sub:
                    ev = RouterEvent.unpack(payload)
                    events.append(ev)
                    indexer.apply_event(ev)
                    if len(events) == n:
                        return

            await asyncio.wait_for(asyncio.to_thread(native_calls), 30)
            await asyncio.wait_for(drain(3), 10)
            stored = indexer.find_matches_for_tokens(prompt).scores
            await asyncio.wait_for(asyncio.to_thread(native_remove), 30)
            await asyncio.wait_for(drain(5), 10)
            removed = indexer.find_matches_for_tokens(prompt).scores
            await rt.shutdown()
            return events, stored, removed
        finally:
            await server.stop()

    events, stored, removed = asyncio.run(main())
    assert [e.event.event_id for e in events] == [1, 2, 3, 4, 5]
    assert all(e.worker_id == "w-native" for e in events)
    d1, d2, d3 = (e.event.data for e in events[:3])
    assert isinstance(d1, KvCacheStoreData) and d1.parent_hash is None
    assert [(b.block_hash, b.tokens_hash) for b in d1.blocks + d2.blocks] \
        == [(bh, tokens_hash(t)) for bh, t in blocks]
    assert d2.parent_hash == blocks[1][0]
    assert len(d3.blocks) == 20
    assert d3.blocks[7].tokens_hash == tokens_hash([7] * page)
    d4 = events[3].event.data
    assert isinstance(d4, KvCacheRemoveData)
    assert d4.block_hashes == [bh for bh, _ in blocks]
    assert stored == {"w-native": 5}
    assert not removed.get("w-native")


def test_uninitialized_calls_fail_fast(capi):
    with pytest.raises(IOError):
        capi.publish_removed(1, [1, 2])
    with pytest.raises(IOError):
        capi.publish_stored(1, None, [(1, [0] * 16)])
