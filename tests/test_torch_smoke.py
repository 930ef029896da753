"""The port's ``make smoke`` gate (``boinc_app_eah_brp_tpu_torch/tools/
smoke.py``) on the CPU: the default gate passes on the JAX smoke's
fixture and fails on a planted black-box dump, on a health violation and
on a lost span; ``--hosts 2`` and ``--fabric`` pass (``slow``, as the JAX
package's ``test_smoke_harness_passes``)."""

import os
import subprocess
import sys

import pytest

from boinc_app_eah_brp_tpu_torch.tools import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _work(tmp_path):
    work = str(tmp_path / "smoke")
    os.makedirs(work)
    return work


def test_default_gate_passes_on_the_cpu(tmp_path, capsys):
    work = _work(tmp_path)
    res = smoke.gate(work, *smoke.fixture(work), device="cpu")
    out = capsys.readouterr().out
    assert res["coverage"] >= smoke.COVERAGE_MIN
    assert res["health_checks"] > 0
    assert res["wall_s"] > 0
    for name in ("metrics.jsonl", "run.trace.jsonl", "run.trace.jsonl.chrome.json", "metrics.jsonl.report.json"):
        assert f"{name}: OK" in out, out
    assert "checkpoint audit OK" in out and "precision artifacts OK" in out


def test_cli_passes_and_cleans_up(tmp_path, capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smoke: PASS" in out
    work = out.split("smoke: workdir ", 1)[1].split()[0]
    assert not os.path.exists(work)


def test_planted_blackbox_dump_fails_the_gate(tmp_path):
    work = _work(tmp_path)
    with open(os.path.join(work, "erp-blackbox-4242.json"), "w") as f:
        f.write("{}")
    with pytest.raises(smoke.SmokeFailed, match="black-box dump on a clean run"):
        smoke.gate(work, *smoke.fixture(work), device="cpu")


def test_health_violation_fails_the_gate(tmp_path, monkeypatch):
    """A sentinel tolerance no probe can meet: the run aborts on its
    first probe (RADPUL_EVAL) with a black box, and the gate fails."""
    monkeypatch.setenv("ERP_HEALTH_TOL", "-1")
    work = _work(tmp_path)
    with pytest.raises(smoke.SmokeFailed, match="driver exited 4"):
        smoke.gate(work, *smoke.fixture(work), device="cpu")
    assert [n for n in os.listdir(work) if n.startswith("erp-blackbox-")]


def test_lost_trace_fails_the_gate(tmp_path, monkeypatch):
    """A run whose host trace goes missing fails on its artifacts."""
    work = _work(tmp_path)
    real = smoke.subprocess.run

    def run_then_drop_trace(*a, **k):
        r = real(*a, **k)
        os.remove(os.path.join(work, "run.trace.jsonl.chrome.json"))
        return r

    monkeypatch.setattr(smoke.subprocess, "run", run_then_drop_trace)
    with pytest.raises(smoke.SmokeFailed, match="no trace artifact"):
        smoke.gate(work, *smoke.fixture(work), device="cpu")


def test_gate_without_a_card_raises(tmp_path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    work = _work(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke.gate(work, *smoke.fixture(work))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ERP_QUORUM_KEY", None)
    return subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.smoke", "--device", "cpu", *args],
                          env=env, capture_output=True, text=True, timeout=600)


@pytest.mark.slow
def test_hosts_gate_passes(tmp_path):
    r = _cli("--hosts", "2", "--workdir", str(tmp_path / "hosts"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "smoke: PASS (2 hosts, 2 shards" in r.stdout


@pytest.mark.slow
def test_fabric_gate_passes(tmp_path):
    r = _cli("--fabric", "--workdir", str(tmp_path / "fabric"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "8 WUs granted by 8 honest streams, 0 rejections, 0 re-issues, 8 verdicts OK" in r.stdout
