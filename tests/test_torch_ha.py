"""The port's HA control plane held to the JAX package's.

Every case of tests/test_ha.py runs on the port's server and client
(dynamo_tpu_torch/runtime/transports/{server,tcp,journal}.py): replicate,
promote and serve; partition fencing with no divergent acknowledgements;
a promoted member refusing a stale snapshot; an evicted standby
re-bootstrapping without promoting; the comma form and a mid-failover
retry. The two packages speak one wire format and one journal format, so
the cross cases mix them: a standby of one package replicates a primary of
the other and promotes, each package's client follows the other's pair,
and a data directory written by either `DurablePlane` is recovered by the
other into the same KV and queue state (record bytes equal, a torn tail
dropped by both). The lease-loss case holds the port to the JAX lease
watch: after a promotion, a runtime that held a lease on the dead primary
shuts down (leases are not replicated). All of it is exact: states,
epochs, roles and bytes.
"""
import asyncio
import os
import time

import pytest

import dynamo_tpu.runtime.distributed as jdist
from dynamo_tpu.runtime.transports import journal as jjournal
from dynamo_tpu.runtime.transports import memory as jmemory
from dynamo_tpu.runtime.transports.server import (
    ControlPlaneServer as JServer,
)
from dynamo_tpu.runtime.transports.tcp import ControlPlaneClient as JClient
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.transports import journal as tjournal
from dynamo_tpu_torch.runtime.transports import memory as tmemory
from dynamo_tpu_torch.runtime.transports.server import ControlPlaneServer
from dynamo_tpu_torch.runtime.transports.tcp import ControlPlaneClient

SERVERS = {"jax": JServer, "port": ControlPlaneServer}
CLIENTS = {"jax": JClient, "port": ControlPlaneClient}


def run(coro):
    return asyncio.run(coro)


async def wait_for(cond, timeout=10.0, what="condition"):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.05)


def test_standby_replicates_promotes_and_serves(tmp_path):
    async def main():
        primary = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "a")).start()
        rt = await DistributedRuntime.connect("127.0.0.1", primary.port, "w")
        await rt.kv.put("models/m1", b"card1")
        for i in range(3):
            await rt.messaging.queue_push("prefill", f"job{i}".encode())

        standby = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="standby sync")
        assert standby.role == "standby"

        # writes after the snapshot ride the record stream
        await rt.kv.put("models/m2", b"card2")
        assert await rt.messaging.queue_pop("prefill", 1.0) == b"job0"
        await wait_for(
            lambda: "models/m2" in standby.plane.kv._data, what="stream kv")
        await wait_for(
            lambda: standby.plane.messaging._queues["prefill"].qsize() == 2,
            what="stream qpop")

        # a standby refuses client ops (clients must follow the primary)
        with pytest.raises(ConnectionError):
            await ControlPlaneClient(
                "127.0.0.1", standby.port).connect(timeout_s=0.6)

        await rt.shutdown()
        await primary.stop()
        await wait_for(lambda: standby.role == "primary", what="promotion")
        assert standby.epoch == 2

        rt2 = await DistributedRuntime.connect(
            "127.0.0.1", 0, "w2",
            addrs=[("127.0.0.1", primary.port),
                   ("127.0.0.1", standby.port)])
        assert rt2.epoch == 2
        assert await rt2.kv.get("models/m1") == b"card1"
        assert await rt2.kv.get("models/m2") == b"card2"
        assert await rt2.messaging.queue_pop("prefill", 1.0) == b"job1"
        await rt2.kv.put("models/m3", b"card3")
        await rt2.messaging.queue_push("prefill", b"job3")
        await rt2.shutdown()
        await standby.stop()

        # the promoted standby's own journal is complete
        reborn = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b")).start()
        assert reborn.epoch == 2
        rt3 = await DistributedRuntime.connect("127.0.0.1", reborn.port, "w3")
        assert await rt3.kv.get("models/m1") == b"card1"
        assert await rt3.kv.get("models/m3") == b"card3"
        assert await rt3.messaging.queue_depth("prefill") == 2
        assert await rt3.messaging.queue_pop("prefill", 1.0) == b"job2"
        await rt3.shutdown()
        await reborn.stop()

    run(main())


def test_partition_fencing_no_divergent_acks(tmp_path):
    async def main():
        primary = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "a")).start()
        c1 = await ControlPlaneClient("127.0.0.1", primary.port).connect()
        await c1.put("k", b"v1")
        assert c1.epoch == 1 and primary.epoch == 1

        standby = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="standby sync")

        # partition: the standby sees the primary as dead, while the
        # primary keeps serving c1
        async def _unreachable(host, port):
            return False
        standby._primary_alive = _unreachable
        for _sid, (_q, conn) in list(primary.repl_subs.items()):
            conn.writer.close()
        await wait_for(lambda: standby.role == "primary", what="promotion")
        assert standby.epoch == 2

        both = [("127.0.0.1", primary.port), ("127.0.0.1", standby.port)]
        c2 = await ControlPlaneClient(addrs=both).connect()
        assert c2.port == standby.port and c2.epoch == 2
        await c2.put("k", b"v2")

        await wait_for(lambda: primary.role != "primary", timeout=15,
                       what="old primary deposed")
        assert primary.epoch == 2
        await wait_for(lambda: primary.role == "standby" and primary.synced,
                       timeout=15, what="old primary rejoined as standby")
        await wait_for(
            lambda: primary.plane.kv._data.get("k") is not None
            and primary.plane.kv._data["k"].value == b"v2",
            what="rejoined standby re-synced")

        with pytest.raises((RuntimeError, ConnectionError)):
            await c1.put("k", b"v-stale")

        c2.epoch = 1
        with pytest.raises(RuntimeError, match="stale epoch"):
            await c2.put("k", b"v-old-epoch")
        c2.epoch = 2

        await c1.close()
        c1b = await ControlPlaneClient(addrs=both).connect()
        assert c1b.port == standby.port and c1b.epoch == 2
        assert await c1b.get("k") == b"v2"

        # a member restarting from its data dir comes back as primary at
        # its old epoch and is re-fenced into a standby
        p_port = primary.port
        await primary.stop()
        reborn = await ControlPlaneServer(
            host="127.0.0.1", port=p_port,
            data_dir=str(tmp_path / "a")).start()
        assert reborn.epoch <= 2
        await wait_for(lambda: reborn.role == "standby" and reborn.synced,
                       timeout=15,
                       what="reborn stale primary re-fenced to standby")

        await c1b.close()
        await c2.close()
        await reborn.stop()
        await standby.stop()

    run(main())


def test_promoted_member_refuses_stale_snapshot_and_resumes_primacy(
        tmp_path):
    async def main():
        a = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "a")).start()
        c = await ControlPlaneClient("127.0.0.1", a.port).connect()
        await c.put("k", b"v1")
        b = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", a.port)).start()
        await wait_for(lambda: b.synced, what="sync")

        async def _unreachable(host, port):
            return False

        async def _no_fence(host, port):
            await asyncio.Event().wait()

        b._primary_alive = _unreachable
        b._fence_peer = _no_fence
        for _sid, (_q, conn) in list(a.repl_subs.items()):
            conn.writer.close()
        await wait_for(lambda: b.role == "primary", what="promotion")

        c2 = await ControlPlaneClient("127.0.0.1", b.port).connect()
        assert c2.epoch == 2
        await c2.put("k", b"v2-acked")
        await c2.close()
        await b.stop()
        assert a.role == "primary"

        b2 = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", a.port)).start()
        await wait_for(lambda: b2.role == "primary", timeout=15,
                       what="resume primacy")
        assert b2.epoch == 2
        await wait_for(lambda: a.role == "standby" and a.synced,
                       timeout=15, what="stale primary fenced to standby")
        await wait_for(
            lambda: a.plane.kv._data.get("k") is not None
            and a.plane.kv._data["k"].value == b"v2-acked",
            what="rejoined standby holds the winner's history")
        c3 = await ControlPlaneClient("127.0.0.1", b2.port).connect()
        assert c3.epoch == 2
        assert await c3.get("k") == b"v2-acked"

        await c.close()
        await c3.close()
        await a.stop()
        await b2.stop()

    run(main())


def test_evicted_standby_rebootstraps_without_promoting(tmp_path):
    async def main():
        primary = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "a")).start()
        c1 = await ControlPlaneClient("127.0.0.1", primary.port).connect()
        await c1.put("k", b"v1")
        standby = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="standby sync")

        sid, (q, _conn) = next(iter(primary.repl_subs.items()))
        while True:
            try:
                q.put_nowait({"op": "noop"})
            except asyncio.QueueFull:
                break
        primary._fanout_record({"op": "put", "key": "x", "value": b"y"})
        assert sid not in primary.repl_subs

        await wait_for(lambda: standby.synced
                       and len(primary.repl_subs) == 1
                       and sid not in primary.repl_subs,
                       what="re-bootstrap")
        assert standby.role == "standby" and standby.epoch == 1
        assert primary.role == "primary"

        await c1.put("k2", b"v2")
        await wait_for(lambda: "k2" in standby.plane.kv._data,
                       what="stream after re-bootstrap")

        await c1.close()
        await standby.stop()
        await primary.stop()

    run(main())


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_comma_addr_form_and_mid_failover_retry(tmp_path, server, client):
    """The comma form parses, and a client connecting during the failover
    window (primary down, standby not yet promoted) rides it out; each
    package's runtime on each package's pair."""
    Server = SERVERS[server]
    Runtime = (DistributedRuntime if client == "port"
               else jdist.DistributedRuntime)

    async def main():
        primary = await Server(port=0, data_dir=str(tmp_path / "a")).start()
        rt = await Runtime.connect("127.0.0.1", primary.port, "w")
        await rt.kv.put("k", b"v")
        standby = await Server(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="sync")
        p_port, s_port = primary.port, standby.port
        await rt.shutdown()

        async def failover_connect():
            return await Runtime.connect(
                f"127.0.0.1:{p_port},127.0.0.1:{s_port}", 0, "w2")

        task = asyncio.create_task(failover_connect())
        await primary.stop()
        rt2 = await asyncio.wait_for(task, 30)
        assert rt2._client.port == s_port and rt2._client.epoch == 2
        assert await rt2.kv.get("k") == b"v"
        await rt2.shutdown()
        await standby.stop()

    run(main())


@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_cross_package_standby_replicates_and_promotes(
        tmp_path, primary_pkg, standby_pkg):
    """A standby of one package replicates a durable primary of the other
    (snapshot bootstrap, then the record stream) and promotes at epoch 2;
    the other package's client follows the pair to it and reads every
    acknowledged write back."""
    async def main():
        primary = await SERVERS[primary_pkg](
            port=0, data_dir=str(tmp_path / "a")).start()
        c = await CLIENTS[standby_pkg]("127.0.0.1", primary.port).connect()
        await c.put("before", b"snapshot")
        await c.queue_push("q", b"j0")
        standby = await SERVERS[standby_pkg](
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="sync")
        await c.put("after", b"stream")
        await c.queue_push("q", b"j1")
        await c.delete("before")
        await wait_for(
            lambda: "after" in standby.plane.kv._data
            and "before" not in standby.plane.kv._data
            and standby.plane.messaging._queues["q"].qsize() == 2,
            what="stream applied")
        await c.close()
        await primary.stop()
        await wait_for(lambda: standby.role == "primary", what="promotion")
        assert standby.epoch == 2
        c2 = await CLIENTS[primary_pkg](addrs=[
            ("127.0.0.1", primary.port),
            ("127.0.0.1", standby.port)]).connect()
        assert c2.epoch == 2
        assert await c2.get("before") is None
        assert await c2.get("after") == b"stream"
        assert [await c2.queue_pop("q", 1.0) for _ in range(2)] \
            == [b"j0", b"j1"]
        await c2.close()
        await standby.stop()

    run(main())


# -- the journal, read across packages ------------------------------------------

async def _write_history(Plane, data_dir):
    """The same mutations through either package's DurablePlane: leased
    and unleased puts, a leased put shadowing an unleased value, deletes,
    pushes, a pop and an epoch record."""
    plane = Plane(data_dir, fsync=False)
    kv, mq = plane.kv, plane.messaging
    await kv.put("a", b"1")
    await kv.put("b", b"2")
    await kv.put("c", b"3")
    await kv.put("leased", b"x", lease_id=7)
    await kv.put("c", b"shadow", lease_id=7)   # journals a del of "c"
    await kv.delete("a")
    await kv.put("b", b"2b")
    for i in range(4):
        await mq.queue_push("prefill", f"job{i}".encode())
    assert await mq.queue_pop("prefill", 1.0) == b"job0"
    await mq.queue_push("other", b"\x00\xffbin")
    plane.journal.record_epoch(3)
    plane.journal.sync()
    plane.close()


def _state(plane):
    kv = {k: e.value for k, e in sorted(plane.kv._data.items())}
    queues = {n: list(q._queue) for n, q in plane.messaging._queues.items()
              if q.qsize()}
    return kv, queues, plane.journal.epoch


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_cross_read_and_torn_tail(tmp_path, writer):
    """A data directory written by one package's DurablePlane is recovered
    by both into the same KV, queue and epoch state; the journal bytes of
    the two writers are equal; a torn tail record is dropped by both."""
    planes = {"jax": jjournal.DurablePlane, "port": tjournal.DurablePlane}
    dirs = {}
    for pkg, Plane in planes.items():
        dirs[pkg] = str(tmp_path / pkg)
        asyncio.run(_write_history(Plane, dirs[pkg]))
    jbytes = {pkg: open(os.path.join(d, "journal.bin"), "rb").read()
              for pkg, d in dirs.items()}
    assert jbytes["jax"] == jbytes["port"]

    async def recover(Plane, d):
        plane = Plane(d, fsync=False)
        try:
            return _state(plane)
        finally:
            plane.close()

    want = ({"b": b"2b"}, {"prefill": [b"job1", b"job2", b"job3"],
                           "other": [b"\x00\xffbin"]}, 3)
    d = dirs[writer]
    assert asyncio.run(recover(planes["jax"], d)) == want
    assert asyncio.run(recover(planes["port"], d)) == want
    # the record readers agree record by record
    path = os.path.join(d, "journal.bin")
    recs = list(tjournal._read_records(path))
    assert recs == list(jjournal._read_records(path))
    assert recs[0] == {"op": "jhead", "gen": 0}
    # a torn tail: half of one more record, as a crash mid-append leaves
    tail = tjournal._LEN.pack(40) + b"\x81\xa2op\xa3put" + b"\x00" * 5
    with open(path, "ab") as f:
        f.write(tail)
    assert list(tjournal._read_records(path)) == recs
    assert list(jjournal._read_records(path)) == recs
    assert asyncio.run(recover(planes["port"], d)) == want
    assert asyncio.run(recover(planes["jax"], d)) == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_compaction_cross_read(tmp_path, writer):
    """Compaction folds the journal into a snapshot (and a fresh journal
    generation); the other package recovers the same state from it, and
    the snapshot files of the two writers are byte-equal."""
    planes = {"jax": jjournal.DurablePlane, "port": tjournal.DurablePlane}

    async def write(Plane, d):
        plane = Plane(d, compact_every=5, fsync=False)
        for i in range(12):
            await plane.kv.put(f"k{i % 4}", f"v{i}".encode())
            await plane.messaging.queue_push("q", f"j{i}".encode())
        await plane.messaging.queue_pop("q", 1.0)
        plane.journal.sync()
        plane.close()

    for pkg, Plane in planes.items():
        asyncio.run(write(Plane, str(tmp_path / pkg)))
    snaps = [open(tmp_path / pkg / "snapshot.bin", "rb").read()
             for pkg in planes]
    assert snaps[0] == snaps[1]

    async def recover(Plane, d):
        plane = Plane(d, fsync=False)
        try:
            return _state(plane)
        finally:
            plane.close()

    d = str(tmp_path / writer)
    want = asyncio.run(recover(planes["jax"], d))
    assert asyncio.run(recover(planes["port"], d)) == want
    assert want[0] == {f"k{i}": f"v{8 + i}".encode() for i in range(4)}
    assert want[1] == {"q": [f"j{i}".encode() for i in range(1, 12)]}


def test_lease_loss_after_promotion_ends_both_runtimes(tmp_path,
                                                       monkeypatch):
    """Leases are not replicated: when the primary dies and the standby
    promotes, the lease watch of a JAX and of a port runtime that held
    leases on the dead primary both fire (distributed.py:84-91); the
    port's runtime ends (shutdown_event set, client closed), and a fresh
    runtime enrolls with the promoted member at epoch 2."""
    monkeypatch.setenv("DYN_LEASE_TTL_S", "1.5")
    monkeypatch.setattr(jdist, "LEASE_TTL_S", 1.5)

    async def main():
        primary = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "a")).start()
        standby = await ControlPlaneServer(
            port=0, data_dir=str(tmp_path / "b"),
            standby_of=("127.0.0.1", primary.port)).start()
        await wait_for(lambda: standby.synced, what="sync")
        pair = f"127.0.0.1:{primary.port},127.0.0.1:{standby.port}"
        jrt = await jdist.DistributedRuntime.connect(pair, 0, "jax-w")
        trt = await DistributedRuntime.connect(pair, 0, "port-w")
        assert trt.epoch == 1 and jrt._client.epoch == 1
        await primary.stop()
        await wait_for(lambda: standby.role == "primary", what="promotion")
        await asyncio.wait_for(trt.shutdown_event.wait(), 10)
        assert trt.lease_lost and trt._client.closed.is_set()
        # the JAX lease watch fired too; its shutdown cancels the watch
        # task it runs in (`self._lease_watch.cancel()`), so it stops at
        # the lease revoke and never sets shutdown_event (ROADMAP.md §C)
        await wait_for(lambda: getattr(jrt, "_shutting_down", False),
                       what="JAX lease watch")
        await wait_for(jrt._lease_watch.done, what="JAX watch ended")
        assert jrt._lease_watch.cancelled()
        assert not jrt.shutdown_event.is_set()
        os.environ["DYN_LEASE_TTL_S"] = "60"   # monkeypatch restores it
        fresh = await DistributedRuntime.connect(pair, 0, "fresh")
        assert fresh.epoch == 2
        await fresh.kv.put("k", b"v")
        assert await fresh.kv.get("k") == b"v"
        await fresh.shutdown()
        await standby.stop()

    run(main())


def test_op_after_connection_end_raises_at_once():
    """The one explained difference of the client (ROADMAP.md §C): once
    the read loop has seen the connection end, the port's client raises a
    ConnectionError at once, where the JAX client sends the frame and
    waits out the op's timeout."""
    import time

    async def main():
        server = await ControlPlaneServer(port=0).start()
        clients = {pkg: await CLIENTS[pkg]("127.0.0.1", server.port)
                   .connect() for pkg in ("jax", "port")}
        for c in clients.values():
            await c.put("k", b"v")
        await server.stop()
        for pkg, c in clients.items():
            await wait_for(c.closed.is_set, what=f"{pkg} read loop end")
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            await clients["port"]._rpc({"op": "get", "key": "k"},
                                       timeout=2.0)
        assert time.monotonic() - t0 < 0.5
        t0 = time.monotonic()
        with pytest.raises(asyncio.TimeoutError):
            await clients["jax"]._rpc({"op": "get", "key": "k"},
                                      timeout=0.5)
        assert time.monotonic() - t0 >= 0.45
        for c in clients.values():
            await c.close()

    run(main())


class _CountingLatency:
    """A LatencyModel of either package that also counts its awaits."""

    def __init__(self, base, delay_s):
        self.model = base(delay_s)
        self.n = 0

    async def apply(self):
        self.n += 1
        await self.model.apply()


async def _latency_trace(pkg, plane_kind, data_dir):
    """The latency model's awaits after each op of one fixed sequence, on
    either package's MemoryPlane or DurablePlane."""
    mem = (jmemory if pkg == "jax" else tmemory)
    lat = _CountingLatency(mem.LatencyModel, 0.001)
    if plane_kind == "memory":
        plane = mem.MemoryPlane(lat)
    else:
        jr = jjournal if pkg == "jax" else tjournal
        plane = jr.DurablePlane(data_dir, latency=lat, fsync=False)
    kv, mq = plane.kv, plane.messaging

    async def echo(payload):
        return payload
    await mq.serve("svc", echo)
    sub = await mq.subscribe("ev")
    trace = []
    ops = [("put", kv.put("a", b"1")), ("create", kv.create("b", b"2")),
           ("create_taken", kv.create("b", b"3")), ("get", kv.get("a")),
           ("get_prefix", kv.get_prefix("")), ("delete", kv.delete("a")),
           ("request", mq.request("svc", b"x")),
           ("publish", mq.publish("ev", b"e")),
           ("queue_push", mq.queue_push("q", b"j")),
           ("queue_pop", mq.queue_pop("q", 1.0))]
    t0 = time.monotonic()
    for name, op in ops:
        await op
        trace.append((name, lat.n))
    elapsed = time.monotonic() - t0
    await sub.aclose()
    if plane_kind == "durable":
        plane.close()
    return trace, elapsed


@pytest.mark.parametrize("plane_kind", ["memory", "durable"])
def test_latency_model_awaited_as_in_jax(tmp_path, plane_kind):
    """The injected delay (memory.py:37): the port's plane awaits it at the
    same ops, as often, as the JAX plane; each await really sleeps."""
    got = {pkg: asyncio.run(_latency_trace(pkg, plane_kind,
                                           str(tmp_path / pkg)))
           for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    # create awaits it, then again through put; queue_pop never does
    assert [n for _, n in got["port"][0]] == [1, 3, 4, 5, 6, 7, 8, 9, 10, 10]
    assert got["port"][1] >= 10 * 0.001


class _Proc:
    """`python -m <args>` from the checkout's root, its merged output read
    line by line into a queue by a thread."""

    def __init__(self, args, env):
        import queue
        import subprocess
        import sys
        import threading
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.lines: list = []
        self.q: queue.Queue = queue.Queue()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=repo,
            env={**os.environ, "PYTHONPATH": repo, **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def pump():
            for line in iter(self.proc.stdout.readline, ""):
                self.lines.append(line.rstrip("\n"))
                self.q.put(line.rstrip("\n"))
        threading.Thread(target=pump, daemon=True).start()

    def line(self, prefix: str, timeout: float = 90.0) -> str:
        import queue
        import time
        deadline = time.monotonic() + timeout
        while True:
            try:
                got = self.q.get(timeout=max(0.01,
                                             deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"no {prefix!r} line:\n"
                                     + "\n".join(self.lines[-20:]))
            if got.startswith(prefix):
                return got


def test_entry_points_take_the_pair_and_end_with_their_lease(tmp_path):
    """The comma form on the entry points as processes: a journaled
    primary and its standby (`--data-dir`, `--standby-of`), then the
    frontend (`--control-host h1:p1,h2:p2`), the router service and the
    exporter (`--coordinator h1:p1,h2:p2`) enroll at epoch 1 (the router
    on the native tree). The primary is SIGKILLed: the standby prints
    PROMOTED, and each of the three ends its runtime on the lost lease
    (`EXIT ... lease_lost=True`, exit 0), as the JAX lease watch says."""
    import signal
    env = {"DYN_LEASE_TTL_S": "3"}
    data = str(tmp_path)
    procs = []
    try:
        server = "dynamo_tpu_torch.runtime.transports.server"
        primary = _Proc([server, "--host", "127.0.0.1", "--port", "0",
                         "--data-dir", os.path.join(data, "a")], env)
        procs.append(primary)
        p_port = int(primary.line("READY control-plane=:").rsplit(":", 1)[1])
        standby = _Proc([server, "--host", "127.0.0.1", "--port", "0",
                         "--data-dir", os.path.join(data, "b"),
                         "--standby-of", f"127.0.0.1:{p_port}"], env)
        procs.append(standby)
        s_port = int(standby.line("READY control-plane=:").rsplit(":", 1)[1])
        pair = f"127.0.0.1:{p_port},127.0.0.1:{s_port}"
        front = _Proc(["dynamo_tpu_torch.frontend.serve", "--host",
                       "127.0.0.1", "--port", "0", "--control-host", pair],
                      env)
        router = _Proc(["dynamo_tpu_torch.kv_router.main", "--coordinator",
                        pair, "--namespace", "ns", "--component", "llm"],
                       env)
        exporter = _Proc(["dynamo_tpu_torch.observability.exporter",
                          "--coordinator", pair, "--namespace", "ns",
                          "--component", "llm", "--port", "0"], env)
        procs += [front, router, exporter]
        assert front.line("ENROLLED epoch=") == "ENROLLED epoch=1"
        front.line("READY http=:")
        assert router.line("READY router") == "READY router indexer=native"
        exporter.line("READY metrics=:")
        standby_role = asyncio.run(_role(s_port))
        assert standby_role == {"id": 1, "role": "standby", "synced": True,
                                "epoch": 1}
        primary.proc.send_signal(signal.SIGKILL)
        standby.line("PROMOTED control-plane=:")
        for p, tag in ((front, "frontend"), (router, "router"),
                       (exporter, "exporter")):
            assert p.line(f"EXIT {tag} ", 30) == \
                f"EXIT {tag} lease_lost=True"
            assert p.proc.wait(timeout=30) == 0
        assert asyncio.run(_role(s_port))["epoch"] == 2
    finally:
        for p in procs:
            if p.proc.poll() is None:
                p.proc.kill()
            p.proc.wait(timeout=30)


async def _role(port):
    from dynamo_tpu_torch.runtime.transports.wire import oneshot_request
    return await oneshot_request("127.0.0.1", port, {"op": "role"}, 5.0)
