"""Per-service configuration: config file -> env JSON -> service view.

Copied from dynamo_tpu/sdk/config.py: the supervisor serializes the whole
config into the DYNAMO_SERVICE_CONFIG environment variable and each
service process reads its own section. JSON always; YAML only where
`pyyaml` is installed, as the JAX loader does.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

ENV_VAR = "DYNAMO_SERVICE_CONFIG"


def load_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
            return yaml.safe_load(text) or {}
        except ImportError:
            raise SystemExit("pyyaml not available; use a .json config")
    return json.loads(text)


class ServiceConfig:
    """The config dict as seen by one service process."""

    _instance: Optional["ServiceConfig"] = None

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    @classmethod
    def global_instance(cls) -> "ServiceConfig":
        if cls._instance is None:
            raw = os.environ.get(ENV_VAR, "{}")
            cls._instance = cls(json.loads(raw))
        return cls._instance

    def for_service(self, name: str) -> Dict[str, Any]:
        return dict(self.data.get(name, {}))

    def get(self, service: str, key: str, default: Any = None) -> Any:
        return self.data.get(service, {}).get(key, default)

    @staticmethod
    def to_env(data: Dict[str, Any]) -> Dict[str, str]:
        return {ENV_VAR: json.dumps(data)}
