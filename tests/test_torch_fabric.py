"""PyTorch port, the volunteer fabric (``fabric/``) against the JAX
package's, on the CPU.

The same seeded inputs go through both packages' hosts, validator and
scheduler; the server backend runs the fixture workunit (4096 samples,
window 200, batch 2, unwhitened) through each package's serving tier.

Tolerances:
* host reports: byte-identical for every host kind, with the same ground
  truth, faults armed in both packages or in neither;
* quorum outcomes: equal verdict, tier, winner, canonical digest and
  per-replica problems, except where the same candidates come in another
  row order (the JAX validator's fuzzy tier grants that, the port's does
  not: ``test_reorder_among_capped_fa_rows_is_granted_by_jax_not_by_the_port``);
  verdict documents equal whole, signature
  included (they carry no wall-clock field: ``VERDICT_WALL_CLOCK_FIELDS``
  is empty), and a verdict signed by either package verifies in the other;
* a fabric driven single-threaded: equal ``summary()`` and an equal
  ``erp-wu-lifecycle/1`` export once its wall-clock fields
  (``LIFECYCLE_WALL_CLOCK_FIELDS``) and the per-process run token are
  removed;
* the server backends: the port's replica and the JAX package's agree at
  the strict tier (byte-identical candidate sections) under both
  packages' validators.
"""

import math
import types

import numpy as np
import pytest

from boinc_app_eah_brp_tpu import fabric as jfb
from boinc_app_eah_brp_tpu.runtime import faultinject as jfi
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu_torch import fabric as pfb
from boinc_app_eah_brp_tpu_torch.io import CP_CAND_DTYPE, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.io.results import ResultHeader, format_candidate_line
from boinc_app_eah_brp_tpu_torch.oracle.stats import chisq_Q
from boinc_app_eah_brp_tpu_torch.oracle.toplist import _SIGMA
from boinc_app_eah_brp_tpu_torch.runtime import faultinject as pfi
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
from fixtures import small_bank, synthetic_timeseries

DATE = "2008-11-12T00:00:00+00:00"
EPOCH = 7
T_OBS = 1.0
PACKAGES = {"jax": jfb, "port": pfb}
# no field of an erp-quorum/1 document is a time: documents compare whole
VERDICT_WALL_CLOCK_FIELDS = frozenset()
# the erp-wu-lifecycle/1 fields that read a clock
LIFECYCLE_WALL_CLOCK_FIELDS = frozenset(
    {"t", "issued_unix", "granted_unix", "grant_latency_s", "validation_s", "compute_s"}
)


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jfi.configure("")
    pfi.configure("")


def fa_of(power: float, n_harm: int) -> float:
    q = float(chisq_Q(2.0 * power * _SIGMA[n_harm], 2 * n_harm))
    return -math.log10(q) if q > 0.0 else 320.0


def ref_bytes(specs, *, gaps=()) -> bytes:
    """A reference result (finalizer-ordered, self-consistent fA)."""
    cands = np.zeros(len(specs), dtype=CP_CAND_DTYPE)
    for i, (f0, power, n_harm) in enumerate(specs):
        cands["f0"][i], cands["P_b"][i], cands["power"][i] = f0, 1000.0, power
        cands["fA"][i], cands["n_harm"][i] = fa_of(power, n_harm), n_harm
    order = np.lexsort((-cands["f0"].astype(np.int64), -cands["power"].astype(np.float64),
                        -cands["fA"].astype(np.float64)))
    header = ResultHeader(user_id=0, host_id=0, date_iso=DATE, quarantined=list(gaps))
    body = header.render() + "".join(format_candidate_line(cands[int(i)], T_OBS) for i in order)
    return (body + "%DONE%\n").encode("utf-8")


REFS = {
    "A": ref_bytes([(400, 40.0, 1), (350, 24.0, 2), (220, 15.0, 4), (130, 9.0, 8)]),
    "B": ref_bytes([(410, 39.0, 1), (300, 21.0, 2)], gaps=[(4, 6)]),
}
STALE = {"A": ref_bytes([(90, 12.0, 2), (70, 8.0, 4)]), "B": ref_bytes([(95, 11.0, 2)])}


def truths(host):
    return [(t.wu_id, t.lied, t.kind, t.stalled) for t in host.truths]


# ---------------------------------------------------------------------------
# hosts


def test_kinds_and_names_match():
    assert pfb.HOST_KINDS == jfb.HOST_KINDS and pfb.ADVERSARY_KINDS == jfb.ADVERSARY_KINDS
    assert pfb.__all__ == jfb.__all__
    assert (pfb.QUORUM_SCHEMA, pfb.DEFAULT_POWER_RTOL, pfb.DEFAULT_FA_ATOL, pfb.DEFAULT_PARAM_RTOL) == (
        jfb.QUORUM_SCHEMA, jfb.DEFAULT_POWER_RTOL, jfb.DEFAULT_FA_ATOL, jfb.DEFAULT_PARAM_RTOL)


@pytest.mark.parametrize("faults", [None, "result_report:corrupt@p=0.5;seed=11"])
@pytest.mark.parametrize("kind", jfb.HOST_KINDS)
def test_host_reports_byte_identical(kind, faults):
    """Twelve assignments a host, half its lies by lottery: each report's
    bytes, claimed epoch and stall flag, and the ground truth are the JAX
    package's, with the environmental corruption channel armed or not."""
    if faults:
        jfi.configure(faults)
        pfi.configure(faults)
    hosts = {name: pkg.HostModel(host_id=5, kind=kind, p_lie=0.5, seed=3, date_iso=DATE)
             for name, pkg in PACKAGES.items()}
    pool = [REFS["A"], REFS["B"], STALE["A"]]
    for i in range(12):
        payload = "AB"[i % 2]
        got = {
            name: h.compute(f"wu{i}", REFS[payload], EPOCH, stale_reference_bytes=STALE[payload],
                            echo_pool=list(pool))
            for name, h in hosts.items()
        }
        assert got["port"] == got["jax"], (kind, i)
    assert truths(hosts["port"]) == truths(hosts["jax"])
    assert hosts["port"].lied_wus() == hosts["jax"].lied_wus()
    if kind != "honest":
        assert hosts["port"].lied_wus(), "the lottery never fired"


def test_reputation_matches():
    reps = {name: pkg.HostReputation(host_id=1) for name, pkg in PACKAGES.items()}
    for event in ["valid"] * 3 + ["timeout", "valid", "valid", "valid", "invalid", "valid"]:
        for rep in reps.values():
            getattr(rep, f"record_{event}")()
        assert reps["port"].trusted(3) == reps["jax"].trusted(3)
        assert vars(reps["port"]) == vars(reps["jax"])


# ---------------------------------------------------------------------------
# validator


def _replica_files(tmp_path):
    """Each host kind's report of payload A (honest: two hosts), written
    once and shared by both packages' validators."""
    files = {}
    for host_id, kind in enumerate(("honest", "honest") + jfb.ADVERSARY_KINDS, start=1):
        host = jfb.HostModel(host_id=host_id, kind=kind, seed=2, date_iso=DATE)
        data, epoch, stalled = host.compute("wuA", REFS["A"], EPOCH, stale_reference_bytes=STALE["A"],
                                            echo_pool=[REFS["B"]])
        if stalled:
            data = REFS["A"]  # a late report: the raw reference bytes
        path = tmp_path / f"h{host_id}.{kind}.cand"
        path.write_bytes(data)
        files[host_id] = (kind, str(path), epoch)
    return files


def _outcome_key(out):
    return (
        out.verdict, out.tier, out.winner, out.canonical_sha256,
        [(lr.replica.host_id, lr.sha256, lr.ok, lr.problems, lr.candidate_lines) for lr in out.loaded],
    )


def _strip(doc, fields):
    return {k: v for k, v in doc.items() if k not in fields}


REPLICA_SETS = [(1, 2)] + [(1, k) for k in range(3, 9)] + [(1, 2, 3, 4, 5), (3, 7), (4, 8, 2)]


@pytest.mark.parametrize("members", REPLICA_SETS, ids=lambda m: "-".join(map(str, m)))
def test_validate_quorum_matches(tmp_path, monkeypatch, members):
    monkeypatch.setenv("ERP_QUORUM_KEY", "parity-key")
    files = _replica_files(tmp_path)
    outs = {}
    for name, pkg in PACKAGES.items():
        reps = [pkg.Replica(host_id=h, path=files[h][1], bank_epoch=files[h][2], reputation=h % 3) for h in members]
        outs[name] = pkg.validate_quorum("wuA", reps, T_OBS, expected_epoch=EPOCH,
                                         outdir=str(tmp_path / f"v-{name}"), round_no=2, corr_id="c-wuA")
    assert _outcome_key(outs["port"]) == _outcome_key(outs["jax"])
    assert _strip(outs["port"].doc, VERDICT_WALL_CLOCK_FIELDS) == _strip(outs["jax"].doc, VERDICT_WALL_CLOCK_FIELDS)
    assert open(outs["port"].path).read() == open(outs["jax"].path).read()
    if members == (1, 2):
        assert outs["port"].granted and outs["port"].tier == "strict"


@pytest.mark.parametrize("host", range(1, 9))
def test_validate_single_matches(tmp_path, host):
    files = _replica_files(tmp_path)
    outs = {
        name: pkg.validate_single("wuA", pkg.Replica(host_id=host, path=files[host][1], bank_epoch=files[host][2]),
                                  T_OBS, expected_epoch=EPOCH, corr_id="c1")
        for name, pkg in PACKAGES.items()
    }
    assert _outcome_key(outs["port"]) == _outcome_key(outs["jax"])
    assert _strip(outs["port"].doc, VERDICT_WALL_CLOCK_FIELDS) == _strip(outs["jax"].doc, VERDICT_WALL_CLOCK_FIELDS)


def test_gap_claim_single_needs_quorum_in_both(tmp_path):
    path = tmp_path / "gap.cand"
    path.write_bytes(jfb.HostModel(host_id=4, seed=0, date_iso=DATE).compute("wuB", REFS["B"], EPOCH)[0])
    outs = {name: pkg.validate_single("wuB", pkg.Replica(host_id=4, path=str(path), bank_epoch=EPOCH), T_OBS,
                                      expected_epoch=EPOCH)
            for name, pkg in PACKAGES.items()}
    assert _outcome_key(outs["port"]) == _outcome_key(outs["jax"])
    assert not outs["port"].granted
    assert outs["port"].loaded[0].problems[0].startswith("gap-claim-needs-quorum")


def test_reorder_among_capped_fa_rows_is_granted_by_jax_not_by_the_port(tmp_path):
    """At the production width nearly every candidate sits at the fA cap
    (320; the references of ``chip_smoke.py`` phase (h)), so a reorder
    host's swap among them passes the intrinsic order check.  The JAX validator grants the
    reordered replica with an honest one at the fuzzy tier, and on a
    reputation tie keeps the reordered file as the canonical result; the
    port's finds no tier ("order-mismatch") until a third replica makes a
    strict pair, and the fabric then rejects the reordered replica."""
    capped = ref_bytes([(400 + i, 3000.0 - 10.0 * i, 4) for i in range(6)])
    assert fa_of(2950.0, 4) == 320.0
    paths = {}
    for host_id, kind in ((1, "reorder"), (2, "honest"), (3, "honest")):
        data, _, _ = jfb.HostModel(host_id=host_id, kind=kind, seed=0, date_iso=DATE).compute("wuC", capped, EPOCH)
        paths[host_id] = str(tmp_path / f"h{host_id}.cand")
        open(paths[host_id], "wb").write(data)
    assert open(paths[1], "rb").read() != open(paths[2], "rb").read().replace(b"Host: 2", b"Host: 1")

    def quorum(pkg, hosts):
        reps = [pkg.Replica(host_id=h, path=paths[h], bank_epoch=EPOCH) for h in hosts]
        return pkg.validate_quorum("wuC", reps, T_OBS, expected_epoch=EPOCH)

    jax_out, port_out = quorum(jfb, (1, 2)), quorum(pfb, (1, 2))
    assert all(lr.ok for lr in jax_out.loaded + port_out.loaded)  # no intrinsic problem in either
    assert (jax_out.verdict, jax_out.tier, jax_out.winner) == ("agree", "fuzzy", 0)
    assert (port_out.verdict, port_out.tier, port_out.winner) == ("disagree", None, None)
    assert any("order-mismatch" in m for m in port_out.doc["mismatches"])
    out = quorum(pfb, (1, 2, 3))
    assert (out.verdict, out.tier, out.loaded[out.winner].replica.host_id) == ("agree", "strict", 2)
    assert pfb.compare_replicas(out.loaded[out.winner], out.loaded[0])[0] is None


def test_four_disagreeing_replicas_at_the_ceiling_still_issue_one_more(tmp_path):
    """An honest replica, two reorders of the capped rows and a gap liar
    all pass the intrinsic checks and no two agree under the port's
    validator.  With the target at ``max_target`` (4) the scheduler
    still issues a fifth replica; an honest one makes the strict pair
    and the WU is granted with the reference's bytes, the three liars
    rejected.  (Capped at the ceiling, the WU stayed PENDING with
    nothing to issue: a threaded soak at the production width hung on it.)"""
    from boinc_app_eah_brp_tpu_torch.io.results import split_result_sections

    capped = ref_bytes([(400 + i, 3000.0 - 10.0 * i, 4) for i in range(40)])
    cfg = pfb.FabricConfig(t_obs=T_OBS, bank_epoch=EPOCH, deadline_s=3600.0, seed=0,
                           reissue_base_s=0.0, reissue_max_s=0.0)
    assert cfg.max_target == 4
    fabric = pfb.Fabric(cfg, [pfb.WorkUnit(wu_id="wu0", payload="A", epoch=EPOCH, target=cfg.quorum)],
                        {"A": capped}, str(tmp_path))
    hosts = [pfb.HostModel(host_id=i + 1, kind=k, seed=0, date_iso=DATE)
             for i, k in enumerate(("honest", "reorder", "gap_liar", "reorder", "honest"))]
    rows = {}
    for host in hosts[:4]:
        a = fabric.request_work(host.host_id)
        assert a is not None, f"host {host.host_id} ({host.kind}) was given nothing"
        payload, epoch, _ = host.compute(a.wu_id, capped, EPOCH)
        rows[host.host_id] = split_result_sections(payload.decode())[1]
        fabric.report(a, payload, epoch)
    assert len({tuple(rows[h]) for h in (1, 2, 4)}) == 3  # the two reorders differ from each other too
    wu = fabric._wus["wu0"]
    assert wu.state == "pending" and len(wu.reported()) == 4 and wu.target == 5
    a = fabric.request_work(hosts[4].host_id)
    assert a is not None
    fabric.report(a, *hosts[4].compute(a.wu_id, capped, EPOCH)[:2])
    assert fabric.done() and fabric.summary()["granted"] == 1
    assert (split_result_sections(open(wu.granted_path).read())[1]
            == split_result_sections(capped.decode())[1])
    assert sorted(x.host_id for x in wu.assignments if x.state == "invalid") == [2, 3, 4]


@pytest.mark.parametrize("key", [None, "shared-secret"])
@pytest.mark.parametrize("signer,verifier", [("port", "jax"), ("jax", "port")])
def test_verdict_signature_verifies_across_packages(monkeypatch, key, signer, verifier):
    if key is None:
        monkeypatch.delenv("ERP_QUORUM_KEY", raising=False)
    else:
        monkeypatch.setenv("ERP_QUORUM_KEY", key)
    doc = {"schema": "erp-quorum/1", "wu": "wu7", "t_obs": 1.5, "verdict": "agree", "tier": "strict",
           "winner_host": 3, "canonical_sha256": "ab" * 32, "mismatches": [], "corr_id": "f1s0-wu7",
           "replicas": [{"host": 3, "sha256": "cd" * 32, "intrinsic_ok": True, "problems": []}]}
    signed = PACKAGES[signer].sign_verdict(dict(doc))
    assert signed == jfb.sign_verdict(dict(doc))
    assert PACKAGES[verifier].verify_verdict_signature(signed)
    assert PACKAGES[verifier].validate_quorum_verdict(signed) == []
    forged = dict(signed, winner_host=4)
    assert not PACKAGES[verifier].verify_verdict_signature(forged)


def test_canonical_digest_and_lines_match(tmp_path):
    from boinc_app_eah_brp_tpu.io.results import parse_result as jparse
    from boinc_app_eah_brp_tpu_torch.io.results import parse_result as pparse

    path = tmp_path / "a.cand"
    path.write_bytes(REFS["A"])
    jr, pr = jparse(str(path), t_obs=T_OBS), pparse(str(path), t_obs=T_OBS)
    assert pfb.canonical_candidate_lines(pr) == jfb.canonical_candidate_lines(jr)
    assert pfb.canonical_digest(pr) == jfb.canonical_digest(jr)
    assert pfb.intrinsic_problems(pr, expected_epoch=EPOCH, claimed_epoch=EPOCH - 1, reporter_host=9) == \
        jfb.intrinsic_problems(jr, expected_epoch=EPOCH, claimed_epoch=EPOCH - 1, reporter_host=9)


# ---------------------------------------------------------------------------
# the scheduler, single-threaded


def _drive(pkg, tmp_path, rounds=6):
    """One fabric of ``pkg`` driven by a fixed sequence of calls: every
    round, each host in order asks for work and reports at once (a stall
    host never reports), then the deadlines are checked.  The deadline is
    an hour: nothing can expire by accident."""
    cfg = pkg.FabricConfig(t_obs=T_OBS, bank_epoch=EPOCH, deadline_s=3600.0, seed=4, trust_after=2,
                           spot_check_rate=0.3)
    wus = [pkg.WorkUnit(wu_id=f"wu{i:03d}", payload="AB"[i % 2], epoch=EPOCH, target=cfg.quorum)
           for i in range(10)]
    fabric = pkg.Fabric(cfg, wus, REFS, str(tmp_path))
    kinds = ("honest",) * 5 + pkg.ADVERSARY_KINDS
    hosts = [pkg.HostModel(host_id=i + 1, kind=k, p_lie=0.7, seed=4, date_iso=DATE) for i, k in enumerate(kinds)]
    for _ in range(rounds):
        for h in hosts:
            a = fabric.request_work(h.host_id)
            if a is None:
                continue
            wu = fabric.workunit(a.wu_id)
            data, epoch, stalled = h.compute(a.wu_id, REFS[wu.payload], wu.epoch, stale_reference_bytes=STALE[wu.payload],
                                             echo_pool=fabric.recent_reports(h.host_id))
            if not stalled:
                fabric.report(a, data, epoch)
        assert fabric.check_deadlines() == 0
    return fabric, hosts


def _lifecycle(fabric, path):
    import json

    fabric.export_lifecycle(str(path))
    doc = json.load(open(path))
    token = doc.pop("run_token")

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items() if k not in LIFECYCLE_WALL_CLOCK_FIELDS}
        if isinstance(v, list):
            return [clean(x) for x in v]
        if isinstance(v, str):
            return v.replace(token, "<run>")
        return v

    return clean(doc)


def test_fabric_single_threaded_matches(tmp_path, monkeypatch):
    # re-issue backoff reads the clock: with none of it the call sequence
    # alone decides every state
    monkeypatch.setattr(jfb.workfabric.time, "monotonic", lambda: 1000.0)
    monkeypatch.setattr(pfb.workfabric.time, "monotonic", lambda: 1000.0)
    out = {}
    for name, pkg in PACKAGES.items():
        fabric, hosts = _drive(pkg, tmp_path / name)
        out[name] = (fabric.summary(), _lifecycle(fabric, tmp_path / f"{name}.life.json"),
                     [truths(h) for h in hosts])
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    assert out["port"][0]["granted"] >= 1 and out["port"][0]["hosts_demoted"] >= 1


# ---------------------------------------------------------------------------
# the server backend


@pytest.fixture
def fixture_wu(tmp_path, monkeypatch):
    monkeypatch.setenv("ERP_RESULT_DATE", DATE)
    bank = str(tmp_path / "bank.dat")
    write_template_bank(bank, small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    wu = str(tmp_path / "wu.bin4")
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(wu, ts, tsample_us=500.0, scale=1.0, dm=55.5)

    def args(pkg, name):
        common = dict(inputfile=wu, outputfile=str(tmp_path / f"{name}.cand"), templatebank=bank,
                      checkpointfile=str(tmp_path / f"{name}.cpt"), window=200, batch_size=2)
        return JaxArgs(mesh_devices=1, **common) if pkg == "jax" else DriverArgs(device="cpu", **common)

    return args


def test_compute_backend_env(monkeypatch):
    monkeypatch.delenv("ERP_FABRIC_BACKEND", raising=False)
    assert pfb.compute_backend() == jfb.compute_backend() == "subprocess"
    monkeypatch.setenv("ERP_FABRIC_BACKEND", " Server ")
    assert pfb.compute_backend() == jfb.compute_backend() == "server"


def test_server_backend_mixed_quorum_granted_by_both(tmp_path, fixture_wu, monkeypatch):
    """The port's ServerBackend and the JAX one compute the same workunit;
    each replica goes out through a host of its own package, and both
    validators grant the mixed quorum at the strict tier."""
    monkeypatch.setenv("ERP_QUORUM_KEY", "mixed")
    with pfb.ServerBackend(name="t-port", device="cpu") as backend:
        port_bytes = backend.compute(fixture_wu("port", "port"), corr_id="p0")
        stats = backend.stats()
    with jfb.ServerBackend(name="t-jax") as backend:
        jax_bytes = backend.compute(fixture_wu("jax", "jax"), corr_id="j0")
    assert stats["ok"] == 1 and stats["backend_reconnects"] == 0
    assert port_bytes == open(tmp_path / "port.cand", "rb").read()
    t_obs = 4096 * 500.0e-6
    reports = {
        "jax": jfb.HostModel(host_id=1, date_iso=DATE).compute("wuX", jax_bytes, EPOCH),
        "port": pfb.HostModel(host_id=2, date_iso=DATE).compute("wuX", port_bytes, EPOCH),
    }
    paths = {}
    for name, (data, epoch, _) in reports.items():
        paths[name] = str(tmp_path / f"{name}.report.cand")
        open(paths[name], "wb").write(data)
    for pkg in PACKAGES.values():
        reps = [pkg.Replica(host_id=1, path=paths["jax"], bank_epoch=EPOCH),
                pkg.Replica(host_id=2, path=paths["port"], bank_epoch=EPOCH)]
        out = pkg.validate_quorum("wuX", reps, t_obs, expected_epoch=EPOCH)
        assert out.granted and out.tier == "strict", out.doc["mismatches"]
        assert all(lr.ok for lr in out.loaded)


def test_server_backend_runs_on_its_device(tmp_path, fixture_wu):
    """A backend on the CPU runs args that name the card there."""
    import dataclasses

    with pfb.ServerBackend(name="t-dev", device="cpu") as backend:
        got = backend.compute(dataclasses.replace(fixture_wu("port", "dev"), device="cuda"))
    assert got.endswith(b"%DONE%\n")


def test_server_backend_reconnects_after_restart(tmp_path, monkeypatch):
    import boinc_app_eah_brp_tpu_torch.serving as serving_pkg

    built = []

    class FakeFleet:
        def __init__(self, *, name, warm_specs, resume_dir, device):
            self.resume_dir, self.device, self._stop = resume_dir, device, False
            built.append(self)

        def process(self, args, *, corr_id=None):
            if self._stop:
                raise RuntimeError("FleetServer is closed")
            assert args.device == self.device
            return types.SimpleNamespace(ok=True, name="w", code=0, error=None, outputfile=args.outputfile)

        def stats(self):
            return {"served": 1}

        def close(self):
            self._stop = True

    monkeypatch.setattr(serving_pkg, "FleetServer", FakeFleet)
    (tmp_path / "wu0.cand").write_bytes(b"payload")
    args = DriverArgs(inputfile="wu0.bin4", outputfile=str(tmp_path / "wu0.cand"), templatebank="bank.dat")
    backend = pfb.ServerBackend(name="t-reconnect", resume_dir=str(tmp_path), device="cpu")
    assert backend.compute(args) == b"payload"
    built[0]._stop = True  # a supervised restart tore the server down
    assert backend.compute(args) == b"payload"
    assert len(built) == 2 and built[1].resume_dir == str(tmp_path) and built[1].device == "cpu"
    assert backend.stats()["backend_reconnects"] == 1


def test_server_backend_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfb.ServerBackend(name="t-nocard")


def test_run_streams_converges_like_jax(tmp_path):
    """Threaded streams over a small fleet: both packages grant every
    workunit with the reference's candidates and no lied report valid."""
    from boinc_app_eah_brp_tpu_torch.io.results import split_result_sections

    cfg = pfb.FabricConfig(t_obs=T_OBS, bank_epoch=EPOCH, deadline_s=1.0, seed=1)
    wus = [pfb.WorkUnit(wu_id=f"wu{i}", payload="AB"[i % 2], epoch=EPOCH, target=cfg.quorum) for i in range(6)]
    fabric = pfb.Fabric(cfg, wus, REFS, str(tmp_path))
    hosts = [pfb.HostModel(host_id=i + 1, kind=k, seed=1, date_iso=DATE)
             for i, k in enumerate(("honest",) * 6 + pfb.ADVERSARY_KINDS)]
    assert pfb.run_streams(fabric, hosts, stale_references=STALE, timeout_s=60.0)
    assert fabric.summary()["granted"] == 6
    lied = {h.host_id: h.lied_wus() for h in hosts}
    for wu in fabric.granted():
        _, lines, done = split_result_sections(open(wu.granted_path).read())
        assert done and lines == split_result_sections(REFS[wu.payload].decode())[1]
        assert not [a for a in wu.assignments if a.state == "valid" and wu.wu_id in lied[a.host_id]]
