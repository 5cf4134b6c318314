"""Composable streaming pipeline graph: Source -> Operator* -> Sink.

Copied from dynamo_tpu/runtime/pipeline.py. Every node speaks the
AsyncEngine calling convention (`generate(request, context) -> async
iterator`), an Operator additionally receives the downstream node, and a
Segment is the linked chain: callable like any engine, introspectable, and
rewirable in place (`segment.set_sink(...)`) without rebuilding upstream
state.

    seg = source(preprocess_op).link(router_op).link(engine_sink)
    async for frame in seg.generate(req, ctx): ...
    seg.set_sink(new_engine_sink)        # hot-swap on discovery change

llm/pipeline.py streams every token frame of the model-serving flow
through one of these; the SDK's `Service.link()` uses the same
left-to-right linking convention for deployment graphs.
"""
from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Callable, List, Optional

__all__ = ["Sink", "Operator", "FnSink", "FnOperator", "Segment", "source"]


class Sink(abc.ABC):
    """Terminal node: produces the response stream (an engine)."""

    @abc.abstractmethod
    def generate(self, request: Any, context: Any) -> AsyncIterator:
        ...


class Operator(abc.ABC):
    """Intermediate node: transforms the request and/or response stream,
    delegating to `downstream` (itself a Sink-shaped node)."""

    @abc.abstractmethod
    def generate(self, request: Any, context: Any,
                 downstream: Sink) -> AsyncIterator:
        ...


class FnSink(Sink):
    """Adapt any `async gen fn(request, context)` (or AsyncEngine-shaped
    object) into a Sink node."""

    def __init__(self, fn: Callable[[Any, Any], AsyncIterator]):
        self._fn = fn

    def generate(self, request, context):
        return self._fn(request, context)


class FnOperator(Operator):
    def __init__(self, fn: Callable[[Any, Any, Sink], AsyncIterator]):
        self._fn = fn

    def generate(self, request, context, downstream):
        return self._fn(request, context, downstream)


class _Tail(Sink):
    """Downstream view of a segment from operator position i+1 onward."""

    def __init__(self, segment: "Segment", pos: int):
        self._segment = segment
        self._pos = pos

    def generate(self, request, context):
        return self._segment._dispatch(self._pos, request, context)


class Segment(Sink):
    """A linked Source->Operator*->Sink chain; itself a Sink, so segments
    nest. Operators run outermost-first; `set_sink`/`set_operator` rewire
    the live graph (new requests see the new wiring; in-flight streams
    keep the nodes they captured)."""

    def __init__(self, operators: Optional[List[Operator]] = None,
                 sink: Optional[Sink] = None):
        self.operators: List[Operator] = list(operators or [])
        self.sink = sink

    # -- composition ---------------------------------------------------------

    def link(self, node) -> "Segment":
        """Append a node; Operators extend the chain, a Sink (or async-gen
        callable) terminates it. Returns self for `a.link(b).link(c)`."""
        if isinstance(node, Operator):
            self.operators.append(node)
        elif isinstance(node, Sink):
            if self.sink is not None:
                raise ValueError("segment already has a sink; use "
                                 "set_sink() to replace it")
            self.sink = node
        elif callable(node):
            return self.link(FnSink(node))
        else:
            raise TypeError(f"cannot link {node!r}: expected Operator, "
                            f"Sink, or async-gen callable")
        return self

    def set_sink(self, sink) -> None:
        """Dynamic rewiring: replace the terminal engine (discovery swap)."""
        self.sink = sink if isinstance(sink, Sink) else FnSink(sink)

    def set_operator(self, pos: int, op: Operator) -> None:
        self.operators[pos] = op

    # -- execution -----------------------------------------------------------

    def _dispatch(self, pos: int, request, context) -> AsyncIterator:
        if pos < len(self.operators):
            return self.operators[pos].generate(request, context,
                                                _Tail(self, pos + 1))
        if self.sink is None:
            raise RuntimeError("segment has no sink linked")
        return self.sink.generate(request, context)

    def generate(self, request, context) -> AsyncIterator:
        return self._dispatch(0, request, context)


def source(*nodes) -> Segment:
    """Start a segment, optionally linking initial nodes."""
    seg = Segment()
    for n in nodes:
        seg.link(n)
    return seg
