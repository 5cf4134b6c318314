"""Service/endpoint/depends decorators of the service-graph SDK.

Copied from dynamo_tpu/sdk/service.py: a service is a plain class,
endpoints are async-generator methods, `depends()` edges resolve to
runtime clients at start-up, `Service.link(Target)` / `unlink(Target)`
add and remove such edges after the classes are defined (:59-114), and
`collect_graph` orders a graph's services dependencies first (the launch
order)."""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Type


@dataclasses.dataclass
class ServiceSpec:
    cls: Type
    name: str
    namespace: str
    component: str
    workers: int = 1
    resources: Dict[str, Any] = dataclasses.field(default_factory=dict)
    endpoints: Dict[str, str] = dataclasses.field(default_factory=dict)
    # attribute name -> ServiceSpec-carrying class (fills in at definition)
    dependencies: Dict[str, Type] = dataclasses.field(default_factory=dict)
    start_hooks: List[str] = dataclasses.field(default_factory=list)


class Depends:
    """Declared edge to another service; resolved to an EndpointClients
    bundle in the running process (reference: dependency.py)."""

    def __init__(self, target: Type):
        spec = getattr(target, "__service_spec__", None)
        if spec is None:
            raise TypeError(f"{target!r} is not a @service class")
        self.target = target

    @property
    def spec(self) -> ServiceSpec:
        return self.target.__service_spec__


def depends(target: Type) -> Depends:
    return Depends(target)


def endpoint(name: Optional[str] = None):
    """Mark an async-generator method `(self, request, context)` as a served
    endpoint (reference: @dynamo_endpoint)."""
    def wrap(fn: Callable) -> Callable:
        fn.__endpoint_name__ = name or fn.__name__
        return fn
    return wrap


def async_on_start(fn: Callable) -> Callable:
    """Run after the runtime is connected, before endpoints serve
    (reference: @async_on_start hooks, e.g. engine/model loading)."""
    fn.__on_start__ = True
    return fn


def _link(cls: Type, target: Type, attr: Optional[str] = None) -> Type:
    """Dynamic graph composition (reference: sdk lib/service.py:173
    `.link()`): add a dependency edge cls -> target at runtime — after
    class definition, e.g. when a deploy script assembles Frontend ->
    Processor -> Worker variants from one set of classes. Returns the
    TARGET so chains compose left-to-right along the request path:
    `Frontend.link(Processor).link(Worker)`. `attr` names the instance
    attribute that receives the resolved client bundle (defaults to the
    target's snake_cased service name; collisions raise)."""
    spec = getattr(target, "__service_spec__", None)
    if spec is None:
        raise TypeError(f"{target!r} is not a @service class")
    me: ServiceSpec = cls.__service_spec__
    name = attr or "".join(
        ("_" + c.lower()) if c.isupper() else c
        for c in spec.name).lstrip("_")
    existing = me.dependencies.get(name)
    if existing is not None and existing is not target:
        raise ValueError(
            f"{me.name}.{name} already depends on {existing.__name__}; "
            f"unlink first or pass a different attr")
    me.dependencies[name] = target
    return target


def _unlink(cls: Type, target: Type) -> Type:
    """Remove every dependency edge cls -> target (dynamic rewiring)."""
    me: ServiceSpec = cls.__service_spec__
    for attr in [a for a, t in me.dependencies.items() if t is target]:
        del me.dependencies[attr]
    return cls


def service(name: Optional[str] = None, namespace: str = "dynamo",
            component: Optional[str] = None, workers: int = 1,
            resources: Optional[Dict[str, Any]] = None):
    """Class decorator declaring a deployable component (reference:
    @service(dynamo={...}, resources={...}, workers=N))."""
    def wrap(cls: Type) -> Type:
        svc_name = name or cls.__name__
        eps: Dict[str, str] = {}
        hooks: List[str] = []
        for attr, val in inspect.getmembers(cls):
            if getattr(val, "__endpoint_name__", None):
                eps[val.__endpoint_name__] = attr
            if getattr(val, "__on_start__", False):
                hooks.append(attr)
        deps = {attr: val.target for attr, val in vars(cls).items()
                if isinstance(val, Depends)}
        cls.__service_spec__ = ServiceSpec(
            cls=cls, name=svc_name, namespace=namespace,
            component=component or svc_name, workers=workers,
            resources=dict(resources or {}), endpoints=eps,
            dependencies=deps, start_hooks=hooks)
        cls.link = classmethod(_link)
        cls.unlink = classmethod(_unlink)
        return cls
    return wrap


def collect_graph(root: Type) -> List[ServiceSpec]:
    """All services reachable from `root` through depends() edges,
    dependencies first (the launch order)."""
    seen: Dict[Type, None] = {}

    def visit(cls: Type):
        if cls in seen:
            return
        spec: ServiceSpec = cls.__service_spec__
        for dep_cls in spec.dependencies.values():
            visit(dep_cls)
        seen[cls] = None

    visit(root)
    return [c.__service_spec__ for c in seen]
