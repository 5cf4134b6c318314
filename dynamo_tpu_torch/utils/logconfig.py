"""Env-filtered logging with an optional JSONL sink.

Copied from dynamo_tpu/utils/logconfig.py, over the stdlib logging tree:

- ``DYN_LOG``: comma-separated directives, each either a bare level
  (sets the default) or ``logger.prefix=level``. Later directives win.
  Example: ``DYN_LOG=info,dynamo_tpu_torch.runtime=debug``
- ``DYN_LOGGING_JSONL=1``: one JSON object per line on stderr
  (``ts``, ``level``, ``target``, ``message``, plus exception text).
- ``DYN_LOG_FILE``: also append records to this path (in the same format).

configure_logging() is idempotent (re-running reconfigures rather than
duplicating handlers) and is called by every launch binary of the port
(run.py, llmctl, frontend.serve, kv_router.main, observability.exporter,
the control-plane server, sdk.serve, sdk.run_service and sdk.build
--watch). A binary's READY / EXIT lines stay prints on stdout.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Tuple

_LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

_CONFIGURED_MARK = "_dynamo_tpu_torch_handler"


class JsonlFormatter(logging.Formatter):
    """One JSON object per record: {"ts", "level", "target", "message"}."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
                  + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def parse_filter(spec: str) -> Tuple[int, Dict[str, int]]:
    """Parse a DYN_LOG directive list -> (default_level, {prefix: level}).

    Unknown directives are ignored with a warning on stderr rather than
    failing startup (a typo in an env var must not take the service down).
    """
    default = logging.INFO
    per_target: Dict[str, int] = {}
    for raw in spec.split(","):
        item = raw.strip()
        if not item:
            continue
        if "=" in item:
            target, _, lvl = item.partition("=")
            level = _LEVELS.get(lvl.strip().lower())
            if level is None:
                print(f"DYN_LOG: unknown level {lvl!r} in {item!r}; ignored",
                      file=sys.stderr)
                continue
            per_target[target.strip()] = level
        else:
            level = _LEVELS.get(item.lower())
            if level is None:
                print(f"DYN_LOG: unknown directive {item!r}; ignored",
                      file=sys.stderr)
                continue
            default = level
    return default, per_target


def configure_logging(default: Optional[str] = None) -> None:
    """Install handlers/levels from DYN_LOG / DYN_LOGGING_JSONL / DYN_LOG_FILE.

    `default` seeds the default level when DYN_LOG names none (binaries
    pass their --log-level flag here; env still wins for per-target
    directives).
    """
    spec = os.environ.get("DYN_LOG", "")
    base, per_target = parse_filter(spec)
    if default is not None and not any(
            item.strip() and "=" not in item for item in spec.split(",")):
        base = _LEVELS.get(default.lower(), base)

    root = logging.getLogger()
    # idempotent: drop only handlers we installed earlier (closing them —
    # a reconfigure must not leak the DYN_LOG_FILE descriptor or strand
    # buffered records)
    for h in list(root.handlers):
        if getattr(h, _CONFIGURED_MARK, False):
            root.removeHandler(h)
            h.close()

    jsonl = os.environ.get("DYN_LOGGING_JSONL", "") not in ("", "0", "false")
    if jsonl:
        formatter: logging.Formatter = JsonlFormatter()
    else:
        formatter = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s")
    handlers = [logging.StreamHandler(sys.stderr)]
    log_file = os.environ.get("DYN_LOG_FILE")
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(formatter)
        setattr(h, _CONFIGURED_MARK, True)
        root.addHandler(h)
    root.setLevel(base)

    # reset levels set by a previous configure_logging call so directives
    # removed from DYN_LOG don't linger across reconfigures (tests)
    for name in list(logging.Logger.manager.loggerDict):
        lg = logging.Logger.manager.loggerDict[name]
        if isinstance(lg, logging.Logger) \
                and getattr(lg, _CONFIGURED_MARK, False):
            lg.setLevel(logging.NOTSET)
            delattr(lg, _CONFIGURED_MARK)
    for target, level in per_target.items():
        lg = logging.getLogger(target)
        lg.setLevel(level)
        setattr(lg, _CONFIGURED_MARK, True)
