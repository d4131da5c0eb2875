"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
the CPU (``--device cpu``) at the reduced OLMoE: one-shot, the open loop
through two replicas on driver threads (``--replicas 2``), and at full
precision (``--mode off``). Its JSON report has the reference launcher's
keys: those of the ``dict(...)`` reports in ``repro/launch/serve.py``'s
source (read with ``ast``, so no JAX program is compiled), and the fields
of the dataclasses the reports hold (``CacheStats``, ``SessionHealth``,
``ClusterHealth``); every request completes and both replicas serve;
an error a driver thread caught reaches the caller through the router
``run`` returns; and without ``--device`` the launcher needs CUDA
(``--expert-parallel`` runs in ``tests/test_torch_expert_parallel.py``,
inside its world of 4 ranks)."""
import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from repro.core.cache import CacheStats as JCacheStats
from repro.serving.cluster import ClusterHealth as JClusterHealth
from repro.serving.faults import SessionHealth as JSessionHealth
from repro_torch.launch import serve

REFERENCE = Path(__file__).resolve().parents[1] / "src/repro/launch/serve.py"
SMALL = ["--prompt-len", "8", "--max-new", "4"]
LOOP = SMALL + ["--requests", "4", "--replicas", "2", "--num-slots", "2"]


def _reference_reports():
    """The keyword sets of every ``dict(...)`` call in the reference
    launcher: its one-shot and open-loop reports and its two row forms."""
    tree = ast.parse(REFERENCE.read_text())
    return [{k.arg for k in node.keywords} for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "dict"]


def _fields(cls):
    return {f.name for f in dataclasses.fields(cls)}


def _report(argv, capsys):
    got = serve.main(["--device", "cpu"] + argv)
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == json.loads(
        json.dumps(got))
    return got


def test_one_shot_report_has_the_reference_keys(capsys):
    got = _report(SMALL, capsys)
    assert set(got) in _reference_reports()
    assert "cache" in got and set(got["cache"]) == _fields(JCacheStats)
    assert len(got["tokens"]) == 4 and got["ttft_ms"] > 0


def test_open_loop_through_two_replicas(capsys):
    got = _report(LOOP, capsys)
    reports = _reference_reports()
    assert set(got) in reports and "requests" in got
    assert set(got["health"]) == _fields(JClusterHealth)
    assert set(got["health"]["merged"]) == _fields(JSessionHealth)
    assert all(set(r) in reports for r in got["requests"])
    assert got["replicas"] == 2 and got["n_devices"] == 0
    assert {r["replica"] for r in got["requests"]} == {0, 1}
    assert all("error" not in r and len(r["tokens"]) == 4
               for r in got["requests"])
    assert got["health"]["merged"]["completed"] == 4
    assert got["health"]["status"] == "ok"       # read before the close


def test_full_precision_open_loop_equals_one_shot_tokens(capsys):
    """``--mode off``: no packed store; each request of the open loop (one
    session, two slots) gives the tokens a one-shot run of it gives."""
    args = serve.parse_args(["--device", "cpu", "--mode", "off"] + SMALL
                            + ["--requests", "3"])
    engine = serve.build_engine(args)
    assert engine.qparams is None and not engine.cfg.dymoe.enabled
    report, handles, session = serve.run(args, engine)
    capsys.readouterr()
    assert session.closed
    solo = [engine.generate(h.request).tokens for h in handles]
    assert [h.result().tokens for h in handles] == solo
    assert report["mode"] == "off" and report["replicas"] == 1


def test_open_loop_returns_the_router_with_driver_errors(capsys,
                                                       monkeypatch):
    """A driver thread swallows what ``step``/``maintain`` raise and
    retries; ``run`` hands back the closed router, whose replicas keep the
    last such error, so a caller can fail on it. One injected error: the
    loop still completes every request, and exactly that error shows."""
    from repro_torch.serving.cluster import Replica

    maintain, raised = Replica.maintain, []

    def flaky(self):
        if not raised:
            raised.append(self.index)
            raise RuntimeError("injected driver error")
        return maintain(self)

    monkeypatch.setattr(Replica, "maintain", flaky)
    args = serve.parse_args(["--device", "cpu"] + LOOP)
    report, handles, router = serve.run(args, serve.build_engine(args))
    capsys.readouterr()
    assert router.closed and len(router.replicas) == 2
    errors = {rep.index: rep.last_error for rep in router.replicas}
    assert [i for i, e in errors.items() if e is not None] == raised
    assert str(errors[raised[0]]) == "injected driver error"
    assert report["health"]["merged"]["completed"] == 4
    assert all(h.result().tokens for h in handles)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(SMALL)
