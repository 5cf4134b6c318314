"""The port's native (C++) radix-tree indexer against the JAX package's.

dynamo_tpu_torch/native/kv_indexer.cpp is built with g++ from the
checkout into build/dynamo_tpu_torch/ at first use and loaded with ctypes
(dynamo_tpu_torch/native/radix.py). The three cases of
tests/test_native_indexer.py run on the port, and the same seeded event
streams go through the port's native tree, the JAX native tree and the
port's Python tree: per-worker scores, node counts and per-worker block
counts are equal after every checked step (exact: these are counts). The
default router of each package runs on its native tree, and a failed build
is counted, not silent.
"""
import random

import pytest

from dynamo_tpu.kv_router.indexer import RadixTree as JRadixTree
from dynamo_tpu.kv_router import protocols as jp
from dynamo_tpu_torch import native
from dynamo_tpu_torch.kv_router import protocols as tp
from dynamo_tpu_torch.kv_router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.native import radix

pytestmark = pytest.mark.skipif(
    not radix.available(), reason="no C++ toolchain (g++) on this machine")


def stored(proto, worker, parent, blocks):
    return proto.RouterEvent(worker_id=worker, event=proto.KvCacheEvent(
        event_id=0, data=proto.KvCacheStoreData(
            parent_hash=parent,
            blocks=[proto.KvCacheStoredBlockData(block_hash=b, tokens_hash=t)
                    for b, t in blocks])))


def removed(proto, worker, hashes):
    return proto.RouterEvent(worker_id=worker, event=proto.KvCacheEvent(
        event_id=0, data=proto.KvCacheRemoveData(block_hashes=list(hashes))))


def _trees():
    from dynamo_tpu.native.radix import NativeRadixTree as JNative
    return {"port-native": (radix.NativeRadixTree(), tp),
            "port-python": (RadixTree(), tp),
            "jax-native": (JNative(), jp),
            "jax-python": (JRadixTree(), jp)}


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_native_matches_python_on_random_streams(seed):
    """tests/test_native_indexer.py's random-stream case, with both
    packages' trees beside each other: stores extending or branching a
    worker's chain, removals of its tail, whole-worker removals, and a
    query, node count and block counts compared every 20 steps."""
    rng = random.Random(seed)
    trees = _trees()
    workers = [f"w{i}" for i in range(5)]
    live: dict = {w: [] for w in workers}
    for step in range(400):
        w = rng.choice(workers)
        op = rng.random()
        if op < 0.55:
            chain = live[w]
            parent = chain[-1][0] if chain and rng.random() < 0.7 else 0
            run = []
            for _ in range(rng.randint(1, 4)):
                bh = rng.getrandbits(63) | 1
                th = (rng.getrandbits(16) | 1) if rng.random() < 0.5 \
                    else rng.choice([1, 2, 3, 4, 5])
                run.append((bh, th))
            for tree, proto in trees.values():
                tree.apply_event(stored(proto, w, parent or None, run))
            live[w] = list(run) if parent == 0 else live[w] + run
        elif op < 0.85 and live[w]:
            k = rng.randint(1, min(3, len(live[w])))
            victims = [bh for bh, _ in live[w][-k:]]
            for tree, proto in trees.values():
                tree.apply_event(removed(proto, w, victims))
            live[w] = live[w][:-k]
        else:
            for tree, _ in trees.values():
                tree.remove_worker(w)
            live[w] = []
        if step % 20 == 0:
            q = [rng.choice([1, 2, 3, 4, 5])
                 for _ in range(rng.randint(1, 6))]
            got = {name: (t.find_matches(q).scores, t.num_nodes(),
                          [t.worker_block_count(wk) for wk in workers])
                   for name, (t, _) in trees.items()}
            assert len({repr(v) for v in got.values()}) == 1, got


def test_native_restore_under_new_block_hash_no_dangling():
    """Re-storing a page under a new block_hash then removing both hashes
    leaves no dangling table entry (the JAX C++ use-after-free case)."""
    trees = _trees()
    for tree, proto in trees.values():
        tree.apply_event(stored(proto, "w", None, [(11, 5)]))
        tree.apply_event(stored(proto, "w", None, [(22, 5)]))
        tree.apply_event(removed(proto, "w", [22]))
        tree.apply_event(removed(proto, "w", [11]))
        tree.apply_event(stored(proto, "w", 11, [(33, 6)]))
        tree.apply_event(stored(proto, "w", None, [(44, 7)]))
    for name, (tree, _) in trees.items():
        assert tree.find_matches([5, 6, 7]).scores == {}, name
        assert tree.find_matches([7]).scores == {"w": 1}, name
        assert tree.num_nodes() == 1, name


def test_kv_indexer_uses_native_tree():
    """KvIndexer(native="auto") keeps JAX's meaning: the native tree unless
    frequency tracking is on; `kind` reports it; token queries round-trip
    through the native path; native=False and native=True force either."""
    from dynamo_tpu.kv_router.indexer import KvIndexer as JKvIndexer
    from dynamo_tpu.native.radix import NativeRadixTree as JNative
    idx = KvIndexer(block_size=4)
    assert isinstance(idx.tree, radix.NativeRadixTree)
    assert idx.kind == "native"
    assert isinstance(JKvIndexer(block_size=4).tree, JNative)
    idx2 = KvIndexer(block_size=4, expiration_duration_s=1.0)
    assert isinstance(idx2.tree, RadixTree) and idx2.kind == "python"
    assert KvIndexer(block_size=4, native=False).kind == "python"
    assert KvIndexer(block_size=4, native=True).kind == "native"
    idx.apply_event(stored(tp, "w1", None, [(10, 101), (11, 102)]))
    assert idx.find_matches([101, 102, 103]).scores == {"w1": 2}
    idx.remove_worker("w1")
    assert idx.find_matches([101]).scores == {}
    assert native.library_path("kv_indexer").exists()


def test_default_routers_run_native_trees():
    """The default KvRouter of each package sits on its native tree, so
    the decisions held equal in tests/test_torch_kv_router.py are native
    against native."""
    import asyncio

    from dynamo_tpu.native.radix import NativeRadixTree as JNative
    from dynamo_tpu.kv_router.router import KvRouter as JRouter
    from dynamo_tpu_torch.kv_router.router import KvRouter

    async def main():
        out = []
        for Router in (JRouter, KvRouter):
            r = Router(None, None, 4)
            out.append(r.indexer.tree)
        return out
    jt, tt = asyncio.run(main())
    assert isinstance(jt, JNative)
    assert isinstance(tt, radix.NativeRadixTree)


def test_failed_build_is_counted_and_falls_back(monkeypatch, tmp_path):
    """A build that fails (no compiler) is logged and counted in
    NATIVE_STATS, and the indexer falls back to the Python tree."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    before = native.NATIVE_STATS.build_failures
    idx = KvIndexer(block_size=4)
    assert idx.kind == "python"
    assert native.NATIVE_STATS.build_failures == before + 1
    assert "kv_indexer" in native.NATIVE_STATS.last_error
    with pytest.raises(RuntimeError):
        KvIndexer(block_size=4, native=True)


def test_failed_start_is_counted_and_falls_back(monkeypatch):
    """A library that loads but whose tree fails to start (a missing
    symbol after a source edit raises from ctypes) is counted in
    NATIVE_STATS too; `native="auto"` falls back to the Python tree and
    `native=True` raises."""
    def broken():
        raise AttributeError("undefined symbol: kvi_new")
    monkeypatch.setattr(radix, "available", lambda: True)
    monkeypatch.setattr(radix, "NativeRadixTree", broken)
    before = native.NATIVE_STATS.build_failures
    idx = KvIndexer(block_size=4)
    assert idx.kind == "python"
    assert native.NATIVE_STATS.build_failures == before + 1
    assert native.NATIVE_STATS.last_error.startswith("kv_indexer: start:")
    with pytest.raises(AttributeError):
        KvIndexer(block_size=4, native=True)
    assert native.NATIVE_STATS.build_failures == before + 2
