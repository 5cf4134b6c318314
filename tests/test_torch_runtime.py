"""The port's control plane (dynamo_tpu_torch/runtime) against the JAX
package's (dynamo_tpu/runtime), on the CPU.

(a) The MessagePack codec (runtime/transports/codec.py) against the
    `msgpack` package: byte-identical to `msgpack.packb(obj,
    use_bin_type=True)` and decoding to what `msgpack.unpackb(b,
    raw=False)` gives, on hypothesis-drawn frames and on every integer
    width boundary; the same errors for what neither can encode.
(b) The memory plane: KV put / create / get / delete / prefix, watch
    snapshot + events, lease expiry and revoke, pub/sub with a trailing
    wildcard, queues with leased redelivery.
(c) TCP: the script of tests/test_runtime.py's
    test_tcp_control_plane_end_to_end (serve + generate over the data
    plane, queues, a KV watch across connections) with the port's server
    and the JAX clients, the JAX server and the port's clients, and the
    port on both sides; a request handler awaiting its call-home stream
    survives cyclic garbage collection.
(d) The component model and data plane on a memory plane, as
    tests/test_runtime.py has them: routing policies, deregistration on
    shutdown, lease expiry pruning instances, a mid-stream stop, pub/sub,
    $STATS scrapes, keepalives, the inactivity error, batched watch
    events, and a graceful drain.

Every network await is bounded by asyncio.wait_for; every server binds
port 0.
"""
import asyncio
import contextlib
import gc
import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.runtime import dataplane
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.codec import packb, unpackb
from dynamo_tpu_torch.runtime.transports.memory import MemoryPlane
from dynamo_tpu_torch.runtime.transports.server import ControlPlaneServer
from dynamo_tpu_torch.runtime.transports.wire import MAX_FRAME, pack

T = 30.0  # bound on every test body


def run(coro, timeout: float = T):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def echo_engine(request, context):
    for i in range(int(request.get("n", 3))):
        if context.is_stopped:
            return
        yield {"i": i, "text": request.get("text", "")}


# -- (a) the codec -------------------------------------------------------------

def _same(a, b) -> bool:
    """Structural equality that treats NaN as equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


scalars = (st.none() | st.booleans()
           | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=True, allow_infinity=True)
           | st.text(max_size=300) | st.binary(max_size=300))
frames = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=400, deadline=None)
@given(frames)
def test_codec_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == want
    assert _same(unpackb(want), msgpack.unpackb(want, raw=False))


INT_EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 2**32 - 1,
             2**32, 2**63 - 1, 2**63, 2**64 - 1, -1, -31, -32, -33, -0x80,
             -0x81, -0x8000, -0x8001, -2**31, -2**31 - 1, -2**63]


@pytest.mark.parametrize("x", INT_EDGES)
def test_codec_integer_widths(x):
    want = msgpack.packb(x, use_bin_type=True)
    assert packb(x) == want
    assert unpackb(want) == x and type(unpackb(want)) is int


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_codec_lengths(n):
    """str and bin headers at each length boundary, arrays and maps at
    15 / 16 and 2^16 entries."""
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {str(i): i for i in range(min(n, 70000))}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert packb(obj) == want
        assert unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_errors_match():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            packb(bad)
    for bad in (object(), {1.5}):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            packb(bad)
    with pytest.raises(ValueError):
        unpackb(packb([1, 2]) + b"\x00")   # trailing bytes
    with pytest.raises(ValueError):
        unpackb(packb("truncated")[:-1])
    # a float32 another packer wrote, and the wire's length prefix
    assert unpackb(b"\xca" + bytes.fromhex("3fc00000")) == 1.5
    assert pack({"a": 1})[:4] == len(packb({"a": 1})).to_bytes(4, "big")
    assert MAX_FRAME == 256 * 1024 * 1024


# -- (b) the memory plane -------------------------------------------------------

def test_memory_kv_and_watch():
    async def main():
        plane = MemoryPlane()
        kv = plane.kv
        await kv.put("a/1", b"x")
        assert await kv.create("a/1", b"y") is False
        assert await kv.create("a/2", b"y") is True
        assert await kv.get("a/1") == b"x"
        assert [e.key for e in await kv.get_prefix("a/")] == ["a/1", "a/2"]
        snapshot, events = await kv.watch_prefix("a/")
        assert [(e.key, e.value) for e in snapshot] == [("a/1", b"x"),
                                                         ("a/2", b"y")]
        await kv.put("a/3", b"z")
        await kv.put("b/1", b"other prefix")
        await kv.delete("a/1")
        got = await asyncio.wait_for(events.next_batch(), 2.0)
        assert [(e.kind, e.key, e.value) for e in got] == [
            ("put", "a/3", b"z"), ("delete", "a/1", None)]
        assert events.depth() == 0
        await events.aclose()
        await kv.put("a/4", b"after close")
        assert events.depth() == 0
        assert await kv.get("a/1") is None

    run(main())


def test_memory_lease_expiry_and_revoke():
    async def main():
        kv = MemoryPlane().kv
        short = await kv.grant_lease(0.15)
        await kv.put("w/1", b"v", short.id)
        kept = await kv.grant_lease(0.15)
        await kv.put("w/2", b"v", kept.id)
        for _ in range(6):          # keep-alive holds w/2 past its TTL
            await asyncio.sleep(0.05)
            kept.keep_alive()
        await asyncio.wait_for(short.lost.wait(), 2.0)
        assert await kv.get("w/1") is None
        assert await kv.get("w/2") == b"v"
        await kept.revoke()
        assert await kv.get("w/2") is None

    run(main())


def test_memory_pubsub_and_queues():
    async def main():
        msg = MemoryPlane().messaging
        sub_all = await msg.subscribe("ns.>")
        sub_one = await msg.subscribe("ns.kv")
        await msg.publish("ns.kv", b"1")
        await msg.publish("ns.other", b"2")
        await msg.publish("elsewhere", b"3")
        assert await asyncio.wait_for(sub_all.next_batch(), 2.0) == [
            ("ns.kv", b"1"), ("ns.other", b"2")]
        assert await asyncio.wait_for(anext(sub_one), 2.0) == ("ns.kv", b"1")
        assert sub_one.depth() == 0

        await msg.queue_push("q", b"a")
        await msg.queue_push("q", b"b")
        assert await msg.queue_depth("q") == 2
        assert await msg.queue_pop("q", timeout=1.0) == b"a"
        payload, token = await msg.queue_pop_leased("q", timeout=1.0,
                                                     lease_s=0.05)
        assert payload == b"b"
        assert await msg.queue_touch("q", token, lease_s=0.05) is True
        await asyncio.sleep(0.1)    # lease lapses: b is redelivered
        assert await msg.queue_depth("q") == 1
        assert await msg.queue_touch("q", token) is False
        payload, token = await msg.queue_pop_leased("q", timeout=1.0)
        assert payload == b"b" and msg.redeliveries == 1
        await msg.queue_ack("q", token)
        assert await msg.queue_pop("q", timeout=0.05) is None

        async def handler(payload):
            return payload.upper()
        unserve = await msg.serve("svc", handler)
        assert await msg.request("svc", b"hi", timeout=1.0) == b"HI"
        await unserve()
        with pytest.raises(ConnectionError):
            await msg.request("svc", b"hi", timeout=1.0)

    run(main())


# -- (c) TCP, across the packages -------------------------------------------------

@contextlib.contextmanager
def _jax_tcp_peers(*pkgs):
    """No cyclic garbage collection while a JAX TCP client or server takes
    part: they run request handlers as tasks nothing references
    (dynamo_tpu/runtime/transports/tcp.py:163, server.py:57), which a
    collection can destroy mid-await (a reference fault, ROADMAP §C). The
    port's side is tested under collections in
    test_tcp_handler_survives_cyclic_gc."""
    was = gc.isenabled()
    if "jax" in pkgs:
        gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _pkg(name: str):
    if name == "jax":
        from dynamo_tpu.runtime.distributed import DistributedRuntime as RT
        from dynamo_tpu.runtime.transports.server import (
            ControlPlaneServer as Server,
        )
    else:
        RT, Server = DistributedRuntime, ControlPlaneServer
    return Server, RT


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_tcp_control_plane_end_to_end(server_pkg, client_pkg):
    """tests/test_runtime.py:512-542 with each package on each side."""
    Server, _ = _pkg(server_pkg)
    _, RT = _pkg(client_pkg)

    async def main():
        server = await Server(port=0).start()
        try:
            rt1 = await RT.connect("127.0.0.1", server.port, "w1")
            rt2 = await RT.connect("127.0.0.1", server.port, "c1")
            ep = rt1.namespace("ns").component("echo").endpoint("generate")
            await ep.serve(echo_engine)
            client = rt2.namespace("ns").component("echo").endpoint(
                "generate").client()
            await client.start()
            await client.wait_for_instances()
            frames = [f async for f in await client.generate(
                {"n": 3, "text": "t"})]
            assert [f["i"] for f in frames] == [0, 1, 2]

            await rt1.messaging.queue_push("q1", b"job1")
            assert await rt2.messaging.queue_depth("q1") == 1
            assert await rt2.messaging.queue_pop("q1", timeout=1.0) == b"job1"
            assert await rt2.messaging.queue_pop("q1", timeout=0.05) is None

            snapshot, events = await rt2.kv.watch_prefix("models/")
            assert snapshot == []
            await rt1.kv.put("models/m1", b"v1")
            ev = await asyncio.wait_for(anext(events), 2.0)
            assert (ev.kind, ev.key, ev.value) == ("put", "models/m1", b"v1")
            await rt1.shutdown()
            await rt2.shutdown()
        finally:
            await server.stop()

    with _jax_tcp_peers(server_pkg, client_pkg):
        run(main())


@pytest.mark.parametrize("worker_pkg,client_pkg", [
    ("torch", "jax"), ("jax", "torch")])
def test_tcp_mixed_worker_and_client(worker_pkg, client_pkg):
    """A worker of one package and a client of the other on the port's
    server: the dispatch envelope, the call-home stream and $STATS cross."""
    _, WRT = _pkg(worker_pkg)
    _, CRT = _pkg(client_pkg)

    async def main():
        server = await ControlPlaneServer(port=0).start()
        try:
            w = await WRT.connect("127.0.0.1", server.port, "w1")
            c = await CRT.connect("127.0.0.1", server.port, "c1")
            await w.namespace("ns").component("echo").endpoint(
                "generate").serve(echo_engine,
                                  stats_handler=lambda: {"load": 7})
            client = c.namespace("ns").component("echo").endpoint(
                "generate").client()
            await client.start()
            await client.wait_for_instances()
            frames = [f async for f in await client.generate(
                {"n": 4, "text": "x"})]
            assert frames == [{"i": i, "text": "x"} for i in range(4)]
            assert await client.scrape_stats() == {"w1": {"load": 7}}
            await w.shutdown()
            await c.shutdown()
        finally:
            await server.stop()

    with _jax_tcp_peers(worker_pkg, client_pkg):
        run(main())


def test_tcp_handler_survives_cyclic_gc():
    """A request handler awaiting its call-home handshake is reachable
    only through the client's task set: with cyclic collections running
    throughout, every dispatch still completes."""
    async def slow_engine(request, context):
        await asyncio.sleep(0.01)
        yield {"ok": True}

    async def main():
        server = await ControlPlaneServer(port=0).start()
        stop = asyncio.Event()

        async def collector():
            while not stop.is_set():
                gc.collect()
                await asyncio.sleep(0)

        try:
            w = await DistributedRuntime.connect("127.0.0.1", server.port,
                                                 "w1")
            c = await DistributedRuntime.connect("127.0.0.1", server.port,
                                                 "c1")
            await w.namespace("ns").component("e").endpoint("g").serve(
                slow_engine)
            client = c.namespace("ns").component("e").endpoint(
                "g").client()
            await client.start()
            await client.wait_for_instances()
            gc_task = asyncio.create_task(collector())
            for _ in range(10):
                frames = [f async for f in await asyncio.wait_for(
                    client.generate({}), 10.0)]
                assert frames == [{"ok": True}]
            stop.set()
            await gc_task
            await w.shutdown()
            await c.shutdown()
        finally:
            await server.stop()

    run(main())


# -- (d) the component model on a memory plane -----------------------------------

async def _pair(plane=None, engine=echo_engine, stats=None, wid="w1"):
    plane = plane or MemoryPlane()
    srt = await DistributedRuntime.create_local(plane, wid)
    served = await srt.namespace("ns").component("c").endpoint("gen").serve(
        engine, stats_handler=stats)
    crt = await DistributedRuntime.create_local(plane, "cl")
    client = crt.namespace("ns").component("c").endpoint("gen").client()
    await client.start()
    await client.wait_for_instances()
    return plane, srt, served, crt, client


def test_serve_and_generate_memory_plane():
    async def main():
        _, srt, _, crt, client = await _pair()
        frames = [f async for f in await client.generate(
            {"n": 5, "text": "hi"})]
        assert [f["i"] for f in frames] == list(range(5))
        assert all(f["text"] == "hi" for f in frames)
        await srt.shutdown()
        await crt.shutdown()

    run(main())


def test_routing_policies_and_direct():
    async def main():
        plane = MemoryPlane()
        rts = []
        for wid in ("w1", "w2"):
            rt = await DistributedRuntime.create_local(plane, wid)

            async def eng(req, ctx, wid=wid):
                yield {"worker": wid}
            await rt.namespace("ns").component("c").endpoint("gen").serve(eng)
            rts.append(rt)
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = crt.namespace("ns").component("c").endpoint("gen").client()
        await client.start()
        await client.wait_for_instances()
        assert client.instance_ids() == ["w1", "w2"]
        rr = [[f async for f in await client.generate(
            {}, policy="round_robin")][0]["worker"] for _ in range(4)]
        assert sorted(rr) == ["w1", "w1", "w2", "w2"]
        assert rr[0] != rr[1]
        direct = [f async for f in await client.generate({}, instance="w2")]
        assert direct == [{"worker": "w2"}]
        picked = {[f async for f in await client.generate({})][0]["worker"]
                  for _ in range(20)}
        assert picked == {"w1", "w2"}      # random: both, with 20 draws
        for rt in rts + [crt]:
            await rt.shutdown()

    run(main())


def test_instance_removed_on_shutdown_and_lease_expiry():
    async def main():
        plane, srt, _, crt, client = await _pair()
        await srt.shutdown()
        await asyncio.sleep(0.05)
        assert client.instance_ids() == []
        # a worker whose lease lapses is pruned the same way
        lapsing = await DistributedRuntime.create_local(plane, "w9")
        await lapsing.lease.revoke()
        lapsing.lease = await plane.kv.grant_lease(0.1)
        await lapsing.namespace("ns").component("c").endpoint("gen").serve(
            echo_engine)
        await asyncio.sleep(0.02)
        assert client.instance_ids() == ["w9"]
        await asyncio.wait_for(lapsing.lease.lost.wait(), 2.0)
        await asyncio.sleep(0.05)
        assert client.instance_ids() == []
        await crt.shutdown()

    run(main())


def test_cancellation_stops_stream():
    """A client stop mid-stream reaches the engine's Context over the data
    plane and ends the stream early."""
    seen = {}

    async def slow(request, context):
        for i in range(100):
            if context.is_stopped:
                seen["stopped_at"] = i
                return
            yield {"i": i}
            await asyncio.sleep(0.01)

    async def main():
        _, srt, _, crt, client = await _pair(engine=slow)
        ctx = Context()
        got = []
        async for f in await client.generate({}, ctx):
            got.append(f["i"])
            if len(got) == 3:
                ctx.stop_generating()
        assert len(got) < 20
        for _ in range(100):
            if "stopped_at" in seen:
                break
            await asyncio.sleep(0.01)
        assert 3 <= seen["stopped_at"] < 20
        await srt.shutdown()
        await crt.shutdown()

    run(main())


def test_events_pub_sub():
    async def main():
        rt = await DistributedRuntime.create_local(MemoryPlane(), "w")
        comp = rt.namespace("ns").component("c")
        sub = await comp.subscribe("kv_events")
        other = await rt.namespace("ns").component("d").subscribe("note")
        await comp.publish("kv_events", {"a": [1, 2], "b": b"\x00"})
        await comp.publish("kv_events", "second")
        await rt.namespace("ns").component("d").publish("note", "hello")
        assert await asyncio.wait_for(sub.next_batch(), 2.0) == [
            ("ns.c.kv_events", {"a": [1, 2], "b": b"\x00"}),
            ("ns.c.kv_events", "second")]
        assert await asyncio.wait_for(anext(other), 2.0) == ("ns.d.note",
                                                             "hello")
        assert sub.depth() == 0
        await rt.shutdown()

    run(main())


def test_stats_scrape():
    async def main():
        _, srt, _, crt, client = await _pair(
            stats=lambda: {"kv_active_blocks": 3, "name": "w1"})
        assert await client.scrape_stats() == {
            "w1": {"kv_active_blocks": 3, "name": "w1"}}
        await srt.shutdown()
        await crt.shutdown()

    run(main())


def test_keepalive_survives_slow_first_token(monkeypatch):
    monkeypatch.setattr(dataplane, "KEEPALIVE_INTERVAL_S", 0.05)

    async def slow_first(request, context):
        await asyncio.sleep(0.3)
        yield {"late": True}

    async def main():
        _, srt, _, crt, client = await _pair(engine=slow_first)
        server = await crt.data_plane()
        stream = server.register()
        # the responder's keepalives keep a 0.15 s inactivity window open
        from dynamo_tpu_torch.runtime.transports.codec import packb
        await srt.messaging.request(
            client.endpoint.subject_for("w1"), packb({
                "request_id": "r", "baggage": {}, "payload": packb({}),
                "connection_info": server.connection_info,
                "stream_id": stream.stream_id, "deadline_s": None}))
        got = [x async for x in server.stream_responses(stream, 0.15)]
        assert len(got) == 1
        await srt.shutdown()
        await crt.shutdown()

    run(main())


def test_inactivity_raises_typed_error():
    async def main():
        server = await dataplane.DataPlaneServer().start()
        stream = server.register()
        with pytest.raises(dataplane.StreamInactiveError):
            async for _ in server.stream_responses(stream, timeout=0.1):
                pass
        await server.stop()

    run(main())


def test_uds_path_is_per_process_and_server():
    async def main():
        a = await dataplane.DataPlaneServer().start()
        b = await dataplane.DataPlaneServer().start()
        try:
            import os
            assert a.uds_path != b.uds_path
            assert f"-{os.getpid()}-" in a.uds_path
        finally:
            await a.stop()
            await b.stop()

    run(main())


def test_client_watch_batch_coalesces_flaps():
    async def main():
        plane = MemoryPlane()
        crt = await DistributedRuntime.create_local(plane, "cl")
        client = crt.namespace("ns").component("c").endpoint("gen").client()
        seen = []
        client.add_listener(lambda kind, wid, info: seen.append((kind, wid)))
        await client.start()
        key = client.endpoint.key_for("wx")
        for i in range(5):          # one tick: five flaps of one key
            await plane.kv.put(key, b'{"worker_id": "wx"}')
            await plane.kv.delete(key)
        await plane.kv.put(key, b'{"worker_id": "wx"}')
        await asyncio.sleep(0.05)
        assert seen == [("put", "wx")]
        assert client.instance_ids() == ["wx"]
        await crt.shutdown()

    run(main())


def test_graceful_drain_finishes_inflight_then_deregisters():
    release = asyncio.Event

    async def main():
        gate = release()

        async def held(request, context):
            yield {"i": 0}
            await gate.wait()
            yield {"i": 1}

        _, srt, served, crt, client = await _pair(engine=held)
        stream = await client.generate({})
        first = await asyncio.wait_for(anext(stream), 2.0)
        drain = asyncio.create_task(served.drain(timeout_s=5.0, poll_s=0.01))
        await asyncio.sleep(0.05)
        # DRAINING: fenced out of dispatch, the stream still running
        assert client.draining_ids() == ["w1"]
        assert not drain.done()
        gate.set()
        rest = [f async for f in stream]
        summary = await asyncio.wait_for(drain, 5.0)
        assert [first] + rest == [{"i": 0}, {"i": 1}]
        assert summary == {"worker_id": "w1", "inflight_at_start": 1,
                           "cancelled": 0}
        await asyncio.sleep(0.05)
        assert client.instance_ids() == []
        await srt.shutdown()
        await crt.shutdown()

    run(main())


def _re_role_trace(pkg: str) -> list:
    """tests/test_runtime.py:580's script on one package: a live served
    instance re-roles decode -> prefill through the DRAINING fence beside a
    role-less wildcard, then drains again; the watching client's role lists
    at each checkpoint, in order."""
    if pkg == "jax":
        from dynamo_tpu.runtime.distributed import DistributedRuntime as RT
        from dynamo_tpu.runtime.transports.memory import MemoryPlane as MP

        async def engine(request, context):
            for i in range(request.get("n", 3)):
                yield {"i": i, "text": request.get("text", "")}
    else:
        RT, MP, engine = DistributedRuntime, MemoryPlane, echo_engine

    async def main():
        plane = MP()
        wrt = await RT.create_local(plane, "w-roled")
        art = await RT.create_local(plane, "w-any")
        crt = await RT.create_local(plane, "cl")
        ep = wrt.namespace("ns").component("gen").endpoint("generate")
        served = await ep.serve(engine, metadata={"role": "decode"})
        await art.namespace("ns").component("gen").endpoint(
            "generate").serve(engine)     # role-less wildcard
        client = crt.namespace("ns").component("gen").endpoint(
            "generate").client()
        await client.start()
        await client.wait_for_instances()
        trace = []

        async def wait_for(pred, timeout=5.0):
            deadline = asyncio.get_running_loop().time() + timeout
            while not pred():
                assert asyncio.get_running_loop().time() < deadline, \
                    "condition never held"
                await asyncio.sleep(0.01)

        def snap(tag):
            trace.append((tag, list(client.ids_for_role("decode")),
                          list(client.ids_for_role("prefill")),
                          list(client.draining_ids())))

        await wait_for(lambda: "w-roled" in client.ids_for_role("decode"))
        snap("start")
        res = await served.re_role("prefill", drain_timeout_s=1.0)
        trace.append(("re_role", res["from_role"], res["to_role"],
                      res["inflight_at_start"], res["lingering"]))
        await wait_for(lambda: "w-roled" in client.ids_for_role("prefill"))
        snap("re-roled")
        frames = [f async for f in await client.generate(
            {"n": 2, "text": "post-re-role"}, instance="w-roled")]
        trace.append(("direct", [f["i"] for f in frames]))
        await served.mark_draining()
        await wait_for(
            lambda: "w-roled" not in client.ids_for_role("prefill"))
        snap("draining")
        await crt.shutdown()
        await art.shutdown()
        await wrt.shutdown()
        return trace

    return run(main())


def test_served_endpoint_re_role_fence_and_role_routing():
    """JAX tests/test_runtime.py:580 on the port, traced beside the JAX
    run: the role-less instance serves every role, the re-roled one leaves
    the decode list and joins the prefill list only after the ready
    re-put, requests still route to it, and a draining re-put removes it
    from both lists. The port's trace equals the JAX one."""
    got = _re_role_trace("port")
    assert got == _re_role_trace("jax")
    assert got[0] == ("start", ["w-any", "w-roled"], ["w-any"], [])
    assert got[1] == ("re_role", "decode", "prefill", 0, 0)
    assert got[2] == ("re-roled", ["w-any"], ["w-any", "w-roled"], [])
    assert got[3] == ("direct", [0, 1])
    assert got[4] == ("draining", ["w-any"], ["w-any"], ["w-roled"])
