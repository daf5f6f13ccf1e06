"""The port's launchers and knob audit, on the CPU.

* ``launch.env.KNOBS`` names exactly the ``REPRO_*`` variables the port
  reads: the string literals of that form in ``src/repro_torch``, outside
  ``launch/env.py`` itself;
* ``audit_line`` has the JAX package's format: for the knobs both read,
  the reference's line for the same environment, part for part;
* ``python -m repro_torch.launch.serve`` and ``launch.train`` through
  their ``main(argv)`` on ``--device cpu`` at the reduced config: the
  audit line first, tokens and a Chrome trace from the server (under
  ``REPRO_OBS=1``), a falling loss from the trainer; ``--grad-compress``
  in gspmd mode refused by name; ``RuntimeConfig``'s and
  ``QuantConfig``'s fields and defaults the reference's;
* ``python -m repro_torch.launch.train --reduced --steps 2 --device cpu``
  as a subprocess, once per family (see
  ``test_train_launcher_every_family``);
* the manual data-parallel mode over two gloo ranks: under torchrun
  (``python -m torch.distributed.run --nproc-per-node 2``) and started by
  hand with ``--coordinator localhost:<port>`` and ``RANK`` /
  ``WORLD_SIZE``: exit 0, the step lines from rank 0 alone.
"""

import torch_cpu  # noqa: F401  (one torch thread a test process)
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import env as jenv
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


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_train_launcher_every_family(arch):
    """One config a family through the train launcher as a subprocess, two
    steps of SyntheticLM batches. ``SyntheticLM`` makes no media: vlm
    trains text-only, as the reference's forward allows, and seamless
    stops in ``encdec.encode`` with its named ``ValueError``. The
    reference's launcher stops there too (``python -m repro.launch.train
    --arch seamless-m4t-large-v2 --reduced --steps 2``: an AttributeError
    in its ``encdec.encode``, which reads the missing media)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--steps", "2", "--seq", "64", "--batch", "2",
         "--device", "cpu"],
        cwd=PORT.parents[1], capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(PORT.parent)))
    lines = proc.stdout.splitlines()
    assert lines[0] == env.audit_line(), proc.stderr[-2000:]
    if arch == "seamless-m4t-large-v2":
        assert proc.returncode == 1
        assert ("ValueError: encdec: encode needs the frontend's media"
                in proc.stderr)
        assert len(lines) == 1
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [line.split()[:2] for line in lines[1:]] == [["step", "0"],
                                                        ["step", "1"]]


@pytest.mark.parametrize("name", ["takum8", "takum16"])
def test_grad_compress_in_gspmd_mode_is_refused(name, capsys):
    """One device has no ring to compress (the reference ignores the flag
    there: ``ROADMAP.md`` section 3)."""
    with pytest.raises(SystemExit):
        ltrain.main(["--arch", "phi3-medium-14b", "--reduced", "--steps",
                     "1", "--device", "cpu", "--grad-compress", name])
    err = capsys.readouterr().err
    assert f"--grad-compress {name} compresses the manual" in err
    assert "--dp-mode gspmd runs one device" in err


def test_coordinator_needs_the_ranks_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="needs RANK and WORLD_SIZE"):
        ltrain.main(["--arch", "phi3-medium-14b", "--reduced", "--steps",
                     "1", "--device", "cpu", "--dp-mode", "manual",
                     "--coordinator", "localhost:1"])


@pytest.mark.parametrize("name", ["RuntimeConfig", "QuantConfig"])
def test_runtime_config_fields_are_the_reference_s(name):
    import dataclasses
    from repro.configs import base as jbase
    from repro_torch.configs import base
    mine, ref = getattr(base, name), getattr(jbase, name)

    def fields(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else f.default_factory()) for f in dataclasses.fields(cls)]

    got, want = fields(mine), fields(ref)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)
                if dataclasses.is_dataclass(a) else a == b), n


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(PORT.parent), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    env.update(extra)
    return env


MANUAL = ["-m", "repro_torch.launch.train", "--arch", "phi3-medium-14b",
          "--reduced", "--steps", "2", "--seq", "32", "--batch", "4",
          "--dp-mode", "manual", "--device", "cpu"]


def _step_lines(out):
    return [line.split()[:2] for line in out.splitlines()
            if line.startswith("step")]


def test_manual_data_parallel_under_torchrun():
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port())] + MANUAL
        + ["--grad-compress", "takum16"],
        cwd=PORT.parents[1], capture_output=True, text=True, timeout=240,
        env=_rank_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # rank 0 alone prints: one audit line, one line a step
    assert lines[0] == env.audit_line(), proc.stdout
    assert sum(line.startswith("# repro-config") for line in lines) == 1
    assert _step_lines(proc.stdout) == [["step", "0"], ["step", "1"]]


def test_manual_data_parallel_with_a_coordinator():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable] + MANUAL + ["--coordinator", f"localhost:{port}"],
        cwd=PORT.parents[1], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_rank_env(RANK=str(r), WORLD_SIZE="2"))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[0][0].splitlines()[0] == env.audit_line()
    assert _step_lines(outs[0][0]) == [["step", "0"], ["step", "1"]]
    assert outs[1][0] == ""


def test_grad_spec_from_quant_reads_every_width():
    assert grad_spec_from_quant("none") is None
    for name, fmt, n in (("takum8", "takum", 8), ("takum16", "takum", 16),
                         ("posit8", "posit", 8)):
        spec = grad_spec_from_quant(name)
        assert (spec.fmt, spec.n, spec.scale) == (fmt, n, "none")
    with pytest.raises(ValueError, match="unknown gradient compression"):
        grad_spec_from_quant("lns-takum8")
