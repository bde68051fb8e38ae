"""The port's tracer and profiler capture (``eig_kl_tpu_torch/utils/tracing.py``)
against the JAX package's (``eig_kl_tpu/utils/tracing.py``): the report's
format line for line, no profiler without ``EIG_KL_TPU_PROFILE_DIR``, and
one Chrome trace from the CLI with it."""

import json
import os

import pytest
import torch

from eig_kl_tpu_torch.utils import tracing


def test_report_matches_the_jax_report():
    """Given the same spans and counts, the two reports are equal line for
    line: the header, then the spans by time, descending."""
    from eig_kl_tpu.utils.tracing import Tracer as JaxTracer

    spans = {"kl.pass": 1.25, "spectral": 3.5, "graph.build": 0.0625, "kl.finalize": 0.001953125}
    counts = {"kl.pass": 3, "spectral": 1, "graph.build": 1, "kl.finalize": 3}
    port, ref = tracing.Tracer(), JaxTracer()
    for t in (port, ref):
        t.spans, t.counts = dict(spans), dict(counts)
    assert port.report().splitlines() == ref.report().splitlines()
    assert port.report().splitlines()[1].startswith("spectral")


def test_spans_count_their_calls():
    port = tracing.Tracer("cpu")
    for _ in range(3):
        with port.span("kl.pass"):
            pass
    with port.span("spectral"):
        pass
    assert port.counts == {"kl.pass": 3, "spectral": 1}
    assert set(port.spans) == {"kl.pass", "spectral"}
    assert len(port.report().splitlines()) == 3


def test_maybe_profile_without_the_variable_starts_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(tracing.PROFILE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with tracing.maybe_profile():
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_cli_writes_one_chrome_trace(tmp_path, monkeypatch, capsys):
    """``fused -EIG --solver power --device cpu`` on a 403-node circuit, capped at 20 power steps,
    with the variable set: one Chrome trace whose events name the run's
    operations."""
    from eig_kl_tpu_torch.cli.main import main
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    monkeypatch.chdir(tmp_path)
    CircuitGenerator(0.002, 4).write("c.hgr")
    profile_dir = tmp_path / "profile"
    monkeypatch.setenv(tracing.PROFILE_DIR_ENV, str(profile_dir))
    assert main(["fused", "c.hgr", "-EIG", "--solver", "power", "--device", "cpu", "--power-iters", "20"]) == 0
    assert "Power iterations: 26" in capsys.readouterr().out  # the sign exit checks every 25 steps
    traces = os.listdir(profile_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(profile_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
