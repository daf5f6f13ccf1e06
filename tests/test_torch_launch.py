"""The port's launchers and knob audit, on the CPU.

* ``launch.env.KNOBS`` names exactly the ``REPRO_*`` variables the port
  reads: the string literals of that form in ``src/repro_torch``, outside
  ``launch/env.py`` itself;
* ``audit_line`` has the JAX package's format: for the knobs both read,
  the reference's line for the same environment, part for part;
* ``python -m repro_torch.launch.serve`` and ``launch.train`` through
  their ``main(argv)`` on ``--device cpu`` at the reduced config: the
  audit line first, tokens and a Chrome trace from the server (under
  ``REPRO_OBS=1``), a falling loss from the trainer; ``--dp-mode
  manual``, ``--grad-compress`` and ``--coordinator`` raise, naming the
  roadmap item, and ``RuntimeConfig`` takes none of the reference's
  multi-device fields.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import json
import re
import signal
from pathlib import Path

import pytest

from repro.launch import env as jenv
from repro_torch.configs.base import RuntimeConfig
from repro_torch.launch import env
from repro_torch.launch import serve as lserve
from repro_torch.launch import train as ltrain
from repro_torch.train.trainer import grad_spec_from_quant

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_knobs_are_exactly_what_the_port_reads():
    found = set()
    for path in PORT.rglob("*.py"):
        if path == PORT / "launch" / "env.py":
            continue
        found |= set(re.findall(r"[\"'](REPRO_[A-Z0-9_]+)[\"']",
                                path.read_text()))
    assert found == set(env.KNOBS)
    # every knob the port reads is one the reference reads, with its default
    for name, default in env.KNOBS.items():
        assert name in jenv.KNOBS
        if name != "REPRO_LUT_DECODE":   # "" in both: per-device auto
            assert jenv.KNOBS[name] == default, name


@pytest.mark.parametrize("environ", [{}, {"REPRO_OBS": "2",
                                          "REPRO_FAULT_RATE": "0.5",
                                          "REPRO_LUT_DECODE": "",
                                          "PATH": "/bin"}])
def test_audit_line_has_the_reference_format(environ):
    line = env.audit_line(environ)
    assert line.startswith("# repro-config ")
    parts = line[len("# repro-config "):].split(" ")
    names = [p.split("=")[0] for p in parts]
    assert names == sorted(env.KNOBS)
    jparts = jenv.audit_line(environ)[len("# repro-config "):].split(" ")
    assert [p for p in jparts if p.split("=")[0] in env.KNOBS] == parts
    for name, knob in env.effective_knobs(environ).items():
        assert knob["set"] == (name in environ)
    printed = []
    assert env.log_config(printed.append, environ) == line == printed[0]


def test_host_env_keeps_the_caller_environment():
    out = env.host_env({"FOO": "1"})
    assert out["FOO"] == "1"
    assert out["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == str(
        env.LARGE_ALLOC_THRESHOLD)
    assert "XLA_FLAGS" not in out
    assert env.warn_if_no_tcmalloc(lambda s: None) == env.tcmalloc_active()


def test_serve_launcher_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "1")
    trace = tmp_path / "trace.json"
    outs = lserve.main(["--arch", "phi3-medium-14b", "--reduced",
                        "--weights", "takum8", "--kv-quant", "takum8",
                        "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                        "--device", "cpu", "--trace", str(trace)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == env.audit_line()
    assert "REPRO_OBS=1!" in lines[0]
    assert any(line.startswith("generated 8 tokens") for line in lines)
    assert len(outs) == 2 and all(len(o) == 12 for o in outs)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "request" for e in events)


def test_serve_launcher_refuses_a_trace_without_obs(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    with pytest.raises(SystemExit):
        lserve.main(["--arch", "phi3-medium-14b", "--reduced", "--device",
                     "cpu", "--trace", "x.json"])


@pytest.fixture
def sigterm_restored():
    """The SIGTERM handler back after a run whose checkpoint manager's
    preemption guard took it."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def test_train_launcher_on_cpu(tmp_path, capsys, sigterm_restored):
    params, state, losses = ltrain.main(
        ["--arch", "phi3-medium-14b", "--reduced", "--steps", "6", "--seq",
         "32", "--batch", "4", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == env.audit_line()
    assert [line.split()[1] for line in lines[1:]] == ["0", "5"]
    assert int(state.step) == 6 and len(losses) == 6
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("extra", [["--dp-mode", "manual"],
                                   ["--grad-compress", "takum8"],
                                   ["--dp-mode", "manual",
                                    "--grad-compress", "takum16"],
                                   ["--coordinator", "localhost:1234"]])
def test_train_launcher_multi_device_modes_raise(extra):
    with pytest.raises(NotImplementedError, match="section 1 item 6"):
        ltrain.main(["--arch", "phi3-medium-14b", "--reduced", "--steps",
                     "1", "--device", "cpu"] + extra)


def test_runtime_config_refuses_the_multi_device_fields():
    for field in ("multi_pod", "zero1", "seq_shard", "quant"):
        with pytest.raises(TypeError):
            RuntimeConfig(**{field: None})


def test_grad_spec_from_quant_reads_every_width():
    assert grad_spec_from_quant("none") is None
    for name, fmt, n in (("takum8", "takum", 8), ("takum16", "takum", 16),
                         ("posit8", "posit", 8)):
        spec = grad_spec_from_quant(name)
        assert (spec.fmt, spec.n, spec.scale) == (fmt, n, "none")
    with pytest.raises(ValueError, match="unknown gradient compression"):
        grad_spec_from_quant("lns-takum8")
