"""The port's layered settings and DYN_LOG logging against the JAX package's.

dynamo_tpu_torch/utils/settings.py and utils/logconfig.py are copies of
dynamo_tpu/utils/*: the same inputs (defaults, a TOML / JSON / YAML file,
DYN_* variables; DYN_LOG directive strings) give the same settings dict,
the same filter table and the same level decisions, and the JSONL sink
writes the same keys. Then the launch binaries as processes: the port's
control-plane server, router service and exporter take their defaults from
a DYN_CONFIG file and DYN_* variables, CLI flags beat both, and DYN_LOG /
DYN_LOGGING_JSONL / DYN_LOG_FILE shape their logs.
"""
import json
import logging
import os
import subprocess
import sys
import time

import pytest

from dynamo_tpu.utils import logconfig as jlog
from dynamo_tpu.utils import settings as jset
from dynamo_tpu_torch.utils import logconfig as tlog
from dynamo_tpu_torch.utils import settings as tset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jset, jlog), "torch": (tset, tlog)}
TARGETS = ("dynamo_tpu.engine", "dynamo_tpu.kv_router",
           "dynamo_tpu_torch.runtime", "dynamo_tpu_torch.kv_router")


@pytest.fixture(autouse=True)
def _restore_logging():
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    yield
    for h in list(root.handlers):
        if h not in saved[0]:
            root.removeHandler(h)
            h.close()
    root.handlers[:] = saved[0]
    root.setLevel(saved[1])
    for name in TARGETS:
        logging.getLogger(name).setLevel(logging.NOTSET)


# -- settings -------------------------------------------------------------------

def _both(defaults, **kw):
    out = [dict(m[0].load_settings(defaults, **kw)) for m in PKGS.values()]
    assert out[0] == out[1]
    return tset.load_settings(defaults, **kw)


def test_settings_layering_equals_jax(tmp_path):
    defaults = {"control_plane": {"host": "127.0.0.1", "port": 6230},
                "lease_ttl_s": 10.0, "name": "svc"}
    cfg = tmp_path / "dyn.toml"
    cfg.write_text('lease_ttl_s = 20.0\n[control_plane]\nport = 7000\n')
    s = _both(defaults, config_file=str(cfg), environ={
        "DYN_CONTROL_PLANE__PORT": "9000",
        "DYN_NAME": '"prod"',
        "DYN_UNRELATED_JUNK": "1",       # not in the defaults: no leak
        "DYN_COORD_ADDR": "10.0.0.1:1",  # read elsewhere: ignored
    })
    assert s.control_plane.port == 9000          # env beats file
    assert s.control_plane.host == "127.0.0.1"   # the default survives
    assert s.lease_ttl_s == 20.0                 # file beats default
    assert s.name == "prod"                      # a JSON-parsed string
    assert "unrelated_junk" not in s and "coord_addr" not in s


@pytest.mark.parametrize("kind", ["toml", "json", "yaml", "bare-json",
                                  "bare-toml"])
def test_settings_file_kinds_equal_jax(tmp_path, kind):
    """Each file kind through DYN_CONFIG; YAML where PyYAML imports."""
    if kind == "yaml":
        pytest.importorskip("yaml")
    body = {"toml": ("c.toml", "[a]\nb = 5\nlst = [1, 2]\n"),
            "json": ("c.json", '{"a": {"b": 5, "lst": [1, 2]}}'),
            "yaml": ("c.yaml", "a:\n  b: 5\n  lst: [1, 2]\n"),
            "bare-json": ("c", '{"a": {"b": 5, "lst": [1, 2]}}'),
            "bare-toml": ("c", "[a]\nb = 5\nlst = [1, 2]\n")}[kind]
    path = tmp_path / body[0]
    path.write_text(body[1])
    s = _both({"a": {"b": 1, "c": 2, "lst": []}},
              environ={"DYN_CONFIG": str(path), "DYN_A__C": "7"})
    assert s.a.b == 5 and s.a.c == 7 and s.a.lst == [1, 2]


def test_settings_toml_needs_no_yaml(tmp_path, monkeypatch):
    """TOML and JSON files load with PyYAML absent (the card's machine has
    none): the yaml import stays inside the YAML branch."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "c.toml"
    path.write_text("[router]\nblock_size = 32\n")
    s = tset.load_settings({"router": {"block_size": 64}},
                           config_file=str(path), environ={})
    assert s.router.block_size == 32
    path = tmp_path / "c.json"
    path.write_text('{"router": {"block_size": 16}}')
    assert tset.load_settings({"router": {"block_size": 64}},
                              config_file=str(path),
                              environ={}).router.block_size == 16


def test_settings_env_type_parsing_equals_jax():
    s = _both({"flag": False, "n": 1, "ratio": 0.5, "raw": "x"},
              environ={"DYN_FLAG": "true", "DYN_N": "42",
                       "DYN_RATIO": "0.25", "DYN_RAW": "plain:text"})
    assert s.flag is True and s.n == 42 and s.ratio == 0.25
    assert s.raw == "plain:text"


def test_settings_parent_scalar_and_nested_child_equal_jax():
    s = _both({"control_plane": {"host": "127.0.0.1", "port": 6230}},
              environ={"DYN_CONTROL_PLANE": "10.0.0.1:7411",
                       "DYN_CONTROL_PLANE__PORT": "9000"})
    assert s.control_plane.port == 9000
    assert s.control_plane.host == "127.0.0.1"


# -- logconfig ------------------------------------------------------------------

SPECS = ["", "info", "debug", "trace", "off", "WARN",
         "info,dynamo_tpu.engine=debug,dynamo_tpu.kv_router=warn",
         "bogus,dynamo_tpu.engine=notalevel,error",
         "warning,a.b=debug,a=error,a.b=info",
         " info , x.y = debug ,, critical"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_filter_equals_jax(spec, capsys):
    assert tlog.parse_filter(spec) == jlog.parse_filter(spec)
    capsys.readouterr()


@pytest.mark.parametrize("spec,default", [
    ("warning,{p}.engine=debug", None), ("{p}.engine=debug", "debug"),
    ("error", "debug"), ("", "warning"), ("info,{p}.kv_router=off", None)])
def test_level_decisions_equal_jax(monkeypatch, spec, default):
    """The same directive string gives each package's loggers the same
    enabled levels."""
    decisions = {}
    for name, (_, mod) in PKGS.items():
        p = "dynamo_tpu" if name == "jax" else "dynamo_tpu_torch"
        monkeypatch.setenv("DYN_LOG", spec.format(p=p))
        mod.configure_logging(default)
        decisions[name] = [
            logging.getLogger(f"{p}.{t}").isEnabledFor(lvl)
            for t in ("engine", "kv_router", "other")
            for lvl in (logging.DEBUG, logging.INFO, logging.WARNING,
                        logging.ERROR, logging.CRITICAL)]
        for t in ("engine", "kv_router"):
            logging.getLogger(f"{p}.{t}").setLevel(logging.NOTSET)
    assert decisions["torch"] == decisions["jax"]


def test_reconfigure_resets_dropped_directive(monkeypatch):
    monkeypatch.setenv("DYN_LOG", "warning,dynamo_tpu_torch.runtime=debug")
    tlog.configure_logging()
    lg = logging.getLogger("dynamo_tpu_torch.runtime")
    assert lg.isEnabledFor(logging.DEBUG)
    assert not logging.getLogger("dynamo_tpu_torch.x").isEnabledFor(
        logging.INFO)
    monkeypatch.setenv("DYN_LOG", "warning")
    tlog.configure_logging()
    assert not lg.isEnabledFor(logging.DEBUG)
    # idempotent: one handler of ours however often it runs
    tlog.configure_logging()
    ours = [h for h in logging.getLogger().handlers
            if getattr(h, tlog._CONFIGURED_MARK, False)]
    assert len(ours) == 1


def test_jsonl_records_equal_jax(monkeypatch, capsys, tmp_path):
    """The JSONL sink: the same keys and values (ts apart) on stderr and in
    DYN_LOG_FILE, exception text included."""
    recs = {}
    for name, (_, mod) in PKGS.items():
        monkeypatch.setenv("DYN_LOG", "info")
        monkeypatch.setenv("DYN_LOGGING_JSONL", "1")
        monkeypatch.setenv("DYN_LOG_FILE", str(tmp_path / f"{name}.jsonl"))
        mod.configure_logging()
        lg = logging.getLogger("dynamo_tpu_torch.test")
        lg.info("hello %s", "world")
        lg.debug("not shown")
        try:
            raise ValueError("boom")
        except ValueError:
            lg.exception("bad")
        err = [json.loads(x) for x in
               capsys.readouterr().err.strip().splitlines()]
        for h in list(logging.getLogger().handlers):
            if getattr(h, mod._CONFIGURED_MARK, False):
                logging.getLogger().removeHandler(h)
                h.close()
        with open(tmp_path / f"{name}.jsonl") as f:
            filed = [json.loads(x) for x in f]
        assert filed == err
        for r in err:
            assert r.pop("ts").endswith("Z")
        recs[name] = err
    assert recs["torch"] == recs["jax"]
    assert [r["message"] for r in recs["torch"]] == ["hello world", "bad"]
    assert "ValueError: boom" in recs["torch"][1]["exception"]


# -- the launch binaries ----------------------------------------------------------

def _spawn(module, args, env, tmp_path, tag):
    full = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            "DYN_LOG": "info,dynamo_tpu_torch.runtime=debug,"
                       "dynamo_tpu_torch.controlplane=debug",
            "DYN_LOGGING_JSONL": "1",
            "DYN_LOG_FILE": str(tmp_path / f"{tag}.jsonl"), **env}
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], env=full, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _line(proc, prefix, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix!r} line (rc {proc.poll()})")


def _records(path):
    with open(path) as f:
        recs = [json.loads(x) for x in f]
    for r in recs:
        assert {"ts", "level", "target", "message"} <= set(r), r
    return recs


def _settings(recs, target):
    got = [r["message"] for r in recs
           if r["target"] == target and r["message"].startswith("settings ")]
    assert len(got) == 1, recs
    return json.loads(got[0][len("settings "):])


def test_launch_binaries_take_layered_settings_and_dyn_log(tmp_path):
    """The port's server, router service and exporter as processes with a
    DYN_CONFIG TOML file, DYN_* variables and CLI flags: each effective
    value comes from the layer that should win, and each process writes a
    JSONL log whose debug records are the named targets' only."""
    data = tmp_path / "cp"
    cfg = tmp_path / "dyn.toml"
    cfg.write_text(
        '[control_plane]\nhost = "0.0.0.0"\nport = 1\n'
        f'data_dir = "{data}"\n'
        '[router]\nblock_size = 32\ncoordinator = "127.0.0.1:1"\n'
        '[metrics]\ninterval = 0.25\nport = 1\n')
    procs = []
    try:
        server = _spawn("dynamo_tpu_torch.runtime.transports.server",
                        ["--port", "0"],
                        {"DYN_CONFIG": str(cfg),
                         "DYN_CONTROL_PLANE__HOST": "127.0.0.1"},
                        tmp_path, "server")
        procs.append(server)
        port = int(_line(server, "READY control-plane=:").rsplit(":", 1)[1])
        coord = f"127.0.0.1:{port}"
        router = _spawn("dynamo_tpu_torch.kv_router.main",
                        ["--namespace", "ns", "--component", "w"],
                        {"DYN_CONFIG": str(cfg),
                         "DYN_ROUTER__COORDINATOR": coord,
                         "DYN_ROUTER__BLOCK_SIZE": "64"},
                        tmp_path, "router")
        exporter = _spawn("dynamo_tpu_torch.observability.exporter",
                          ["--namespace", "ns", "--component", "w",
                           "--port", "0"],
                          {"DYN_CONFIG": str(cfg),
                           "DYN_METRICS__COORDINATOR": coord},
                          tmp_path, "exporter")
        procs += [router, exporter]
        assert _line(router, "READY router").startswith("READY router")
        _line(exporter, "READY metrics=:")
    finally:
        for p in procs[::-1]:
            p.terminate()
            p.wait(30)
    s = _settings(_records(tmp_path / "server.jsonl"),
                  "dynamo_tpu_torch.controlplane")
    # file: data_dir; env beats the file's host; the CLI beats its port
    assert s == {"host": "127.0.0.1", "port": 0, "data_dir": str(data),
                 "fsync": True, "standby_of": None}
    assert data.is_dir(), "the server did not open the file's data_dir"
    s = _settings(_records(tmp_path / "router.jsonl"),
                  "dynamo_tpu_torch.router_main")
    assert s == {"coordinator": coord, "block_size": 64}
    s = _settings(_records(tmp_path / "exporter.jsonl"),
                  "dynamo_tpu_torch.metrics_exporter")
    assert s == {"coordinator": coord, "port": 0, "interval": 0.25}
    for tag, target in (("server", "dynamo_tpu_torch.controlplane"),
                        ("router", "dynamo_tpu_torch.runtime"),
                        ("exporter", "dynamo_tpu_torch.runtime")):
        recs = _records(tmp_path / f"{tag}.jsonl")
        debug = [r for r in recs if r["level"] == "DEBUG"]
        assert debug, tag
        assert {r["target"] for r in debug} <= {
            "dynamo_tpu_torch.runtime", "dynamo_tpu_torch.controlplane"}
        assert any(r["target"] == target for r in debug), tag
