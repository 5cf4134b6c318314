"""Layered runtime settings: defaults <- config file <- DYN_* env.

Copied from dynamo_tpu/utils/settings.py. The launch binaries layer their
defaults through it (the control-plane server, the router service and the
metrics exporter), and their CLI flags beat every layer:

    settings = load_settings(
        defaults={"control_plane": {"host": "127.0.0.1", "port": 6230},
                  "lease_ttl_s": 10.0},
        config_file=args.config,           # TOML / YAML / JSON, optional
        env_prefix="DYN_")

Env mapping: ``DYN_LEASE_TTL_S=30`` overrides key ``lease_ttl_s``;
nested keys join with a double underscore, ``DYN_CONTROL_PLANE__PORT=9000``
overrides ``control_plane.port``. Values parse as JSON when possible
(numbers, bools, lists), else stay strings. The config file path itself
can come from ``DYN_CONFIG``. TOML and JSON need only the standard
library; a YAML file imports PyYAML when it is read, and only then.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

__all__ = ["load_settings", "Settings"]


def _parse_scalar(text: str) -> Any:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def _load_toml(body: str) -> Dict[str, Any]:
    try:
        import tomllib  # 3.11+
    except ImportError:  # pragma: no cover — 3.10 fallback
        try:
            import tomli as tomllib
        except ImportError as e:
            raise RuntimeError(
                "TOML config requires Python >= 3.11 (tomllib) or the "
                "tomli package; use YAML or JSON instead") from e
    return tomllib.loads(body)


def _read_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        body = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        return yaml.safe_load(body) or {}
    if path.endswith(".toml"):
        return _load_toml(body)
    if path.endswith(".json"):
        return json.loads(body)
    # extension-less: try JSON, then YAML, then TOML
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
        out = yaml.safe_load(body)
        if isinstance(out, dict):
            return out
    except Exception:  # noqa: BLE001 — fall through to TOML
        pass
    return _load_toml(body)


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _env_overrides(defaults: Dict[str, Any], env_prefix: str,
                   environ: Dict[str, str]) -> Dict[str, Any]:
    """DYN_A__B=c -> {"a": {"b": parsed(c)}} for keys present in defaults.

    Only keys that exist in the defaults tree are taken: unrelated DYN_*
    process envs (DYN_COORD_ADDR etc. consumed elsewhere) must not leak
    into the settings object as junk keys.
    """
    out: Dict[str, Any] = {}
    # shallow keys first: DYN_A=... then DYN_A__B=... must nest cleanly
    # (the deeper override wins over a parent-scalar assignment instead of
    # crashing on a str cursor or being silently replaced)
    names = sorted((n for n in environ if n.startswith(env_prefix)),
                   key=lambda n: n.count("__"))
    for name in names:
        value = environ[name]
        path = name[len(env_prefix):].lower().split("__")
        node, cursor = defaults, out
        ok = True
        for part in path[:-1]:
            if not isinstance(node, dict) or part not in node:
                ok = False
                break
            node = node[part]
            if not isinstance(cursor.get(part), dict):
                cursor[part] = {}
            cursor = cursor[part]
        if not ok or not isinstance(node, dict) or path[-1] not in node:
            continue
        cursor[path[-1]] = _parse_scalar(value)
    return out


class Settings(dict):
    """A dict with attribute access; nested dicts wrap lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return Settings(value) if isinstance(value, dict) else value


def load_settings(defaults: Dict[str, Any],
                  config_file: Optional[str] = None,
                  env_prefix: str = "DYN_",
                  environ: Optional[Dict[str, str]] = None) -> Settings:
    """Layer defaults <- config file <- env; returns attribute-accessible
    Settings. `config_file=None` falls back to the DYN_CONFIG env var."""
    environ = dict(os.environ if environ is None else environ)
    layered = dict(defaults)
    path = config_file or environ.get(env_prefix + "CONFIG")
    if path:
        layered = _deep_merge(layered, _read_config_file(path))
    layered = _deep_merge(layered,
                          _env_overrides(defaults, env_prefix, environ))
    return Settings(layered)
