"""PyTorch port, the multi-process elastic search on the CPU: process
identity (``parallel/distributed.py``), the shard-lease board
(``runtime/resilience.py``), shard states and the cross-process merge
(``parallel/elastic.py``), against the JAX package on the same cases
(``tests/test_distributed.py``).

Exact comparisons throughout: the identity, the ranges, the board's
protocol and the merge are integer and file logic, and every elastic
search's merged (M, T) is bitwise the port's own single-process
``run_bank``.  A board and the shard states written by either package are
joined and loaded by the other.  The lease tests run with lease timeouts
of 0.05-3 s, and every subprocess has its own hard timeout, so a hung
adoption fails fast.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.parallel import distributed as jax_dd
from boinc_app_eah_brp_tpu.parallel import elastic as jax_el
from boinc_app_eah_brp_tpu.runtime import resilience as jax_rs
from boinc_app_eah_brp_tpu_torch.io import TemplateBank, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint, topology_record, verify_checkpoint_audit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.parallel import distributed as dd
from boinc_app_eah_brp_tpu_torch.parallel import elastic as el
from boinc_app_eah_brp_tpu_torch.parallel import make_mesh, run_bank_sharded
from boinc_app_eah_brp_tpu_torch.runtime import metrics
from boinc_app_eah_brp_tpu_torch.runtime import resilience as rs
from boinc_app_eah_brp_tpu_torch.runtime.cli import main
from fixtures import synthetic_timeseries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_NAMES = (dd.ENV_COORDINATOR, dd.ENV_PROCESS_ID, dd.ENV_NUM_PROCESSES, dd.ENV_LOCAL_DEVICES, dd.ENV_SHARD_DIR)


@pytest.fixture(autouse=True)
def _clean_dist_env(monkeypatch):
    """No identity in the environment, and none cached from an earlier
    run in this process (``distributed.initialize`` caches its first)."""
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    dd.reset()
    yield
    dd.reset()
    jax_dd.reset()


# ---------------------------------------------------------------------------
# identity: shard_ranges and config_from_env, the JAX package's outputs


@pytest.mark.parametrize("n,k", [(10, 4), (64, 4), (7, 7), (23, 5), (0, 3), (2, 4), (200, 3)])
def test_shard_ranges_match_jax(n, k):
    got = dd.shard_ranges(n, k)
    assert got == jax_dd.shard_ranges(n, k)
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(got, got[1:]))


def test_shard_ranges_rejects_zero_shards():
    for mod in (dd, jax_dd):
        with pytest.raises(ValueError):
            mod.shard_ranges(8, 0)


@pytest.mark.parametrize(
    "env",
    [
        {},
        {dd.ENV_NUM_PROCESSES: "1"},
        {dd.ENV_NUM_PROCESSES: "4", dd.ENV_PROCESS_ID: "2", dd.ENV_SHARD_DIR: "/tmp/board"},
        {dd.ENV_NUM_PROCESSES: "3", dd.ENV_PROCESS_ID: "0", dd.ENV_LOCAL_DEVICES: "2"},
        {dd.ENV_COORDINATOR: "localhost:29512", dd.ENV_NUM_PROCESSES: "2", dd.ENV_PROCESS_ID: "1"},
    ],
)
def test_config_from_env_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = dd.config_from_env(), jax_dd.config_from_env()
    if want is None:
        assert got is None
        return
    fields = ("num_processes", "process_id", "coordinator", "local_devices", "shard_dir", "host_id", "coordinated")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


@pytest.mark.parametrize(
    "env",
    [
        {dd.ENV_COORDINATOR: "localhost:9999"},
        {dd.ENV_NUM_PROCESSES: "4"},
        {dd.ENV_NUM_PROCESSES: "4", dd.ENV_PROCESS_ID: "4"},
        {dd.ENV_NUM_PROCESSES: "4", dd.ENV_PROCESS_ID: "banana"},
        {dd.ENV_NUM_PROCESSES: "4", dd.ENV_PROCESS_ID: "0", dd.ENV_LOCAL_DEVICES: "0"},
    ],
)
def test_config_rejects_what_jax_rejects(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(jax_dd.DistributedConfigError):
        jax_dd.config_from_env()
    with pytest.raises(dd.DistributedConfigError):
        dd.config_from_env()


def test_initialize_is_idempotent(monkeypatch):
    monkeypatch.setenv(dd.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(dd.ENV_PROCESS_ID, "1")
    cfg = dd.initialize()
    assert cfg is not None and cfg.process_id == 1
    monkeypatch.setenv(dd.ENV_PROCESS_ID, "0")  # ignored from now on
    assert dd.initialize() is cfg and dd.context() is cfg


def test_coordinated_initialize_brings_up_gloo(monkeypatch):
    """One coordinated process (world size 1) on a localhost store: the
    gloo group comes up and reset() ends it."""
    import socket

    import torch.distributed as tdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv(dd.ENV_COORDINATOR, f"127.0.0.1:{port}")
    monkeypatch.setenv(dd.ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(dd.ENV_PROCESS_ID, "0")
    cfg = dd.initialize()
    assert cfg.coordinated and tdist.is_initialized() and tdist.get_world_size() == 1
    dd.reset()
    assert not tdist.is_initialized()


# ---------------------------------------------------------------------------
# the lease board (the cases of the JAX package's tests)


def _board(root, host, timeout_s=0.05, grace_s=0.0, mod=rs):
    return mod.LeaseBoard(str(root), host, timeout_s=timeout_s, grace_s=grace_s)


def _counter(name: str) -> float:
    return (metrics.snapshot()["counters"].get(name) or {}).get("value", 0)


def test_board_publish_then_join(tmp_path):
    ranges, ident = [(0, 8), (8, 16)], {"inputfile": "wu.bin4", "bank": "bank.dat", "n_templates": 16}
    doc = _board(tmp_path, "host0").publish_board(16, ranges, ident)
    assert doc["schema"] == rs.BOARD_SCHEMA == jax_rs.BOARD_SCHEMA
    assert _board(tmp_path, "host1").publish_board(16, ranges, ident)["ranges"] == [[0, 8], [8, 16]]


def test_board_identity_mismatch_refuses_to_join(tmp_path):
    _board(tmp_path, "host0").publish_board(16, [(0, 8), (8, 16)], {"bank": "a.dat"})
    with pytest.raises(rs.LeaseError, match="different search"):
        _board(tmp_path, "host1").publish_board(16, [(0, 8), (8, 16)], {"bank": "b.dat"})


def test_claim_prefers_live_owner(tmp_path):
    b0, b1 = _board(tmp_path, "host0", grace_s=60.0), _board(tmp_path, "host1", grace_s=60.0)
    b0.publish_board(16, [(0, 8), (8, 16)], {})
    b1.heartbeat()
    assert b0.try_claim(1, 8, 16, preferred_owner="host1") is None
    lease = b1.try_claim(1, 8, 16, preferred_owner="host1")
    assert lease is not None and lease.owner == "host1" and lease.epoch == 1


def test_claim_adopts_never_started_host_after_grace(tmp_path):
    metrics.configure(force=True)
    b0 = _board(tmp_path, "host0")
    b0.publish_board(16, [(0, 8), (8, 16)], {})
    lease = b0.try_claim(1, 8, 16, preferred_owner="host1")
    assert lease is not None and lease.owner == "host0"
    assert _counter("resilience.rebalance") == 1 and _counter("resilience.host_lost") == 1


def test_claim_adopts_stale_heartbeat_and_keeps_progress(tmp_path):
    b1, b0 = _board(tmp_path, "host1", timeout_s=0.5), _board(tmp_path, "host0", timeout_s=0.5)
    b1.publish_board(16, [(0, 8), (8, 16)], {})
    b1.heartbeat()
    lease = b1.update(b1.try_claim(1, 8, 16, preferred_owner="host1"), n_done=12, state_path="state-s1.npz")
    assert b0.try_claim(1, 8, 16) is None  # heartbeat still fresh
    time.sleep(0.7)
    adopted = b0.try_claim(1, 8, 16)
    assert adopted.owner == "host0" and adopted.epoch == lease.epoch + 1
    assert adopted.n_done == 12 and adopted.state_path == "state-s1.npz"
    assert b1.update(lease, n_done=14) is None  # the presumed-dead owner abandons


def test_claim_race_is_o_excl_exclusive(tmp_path):
    b0 = _board(tmp_path, "host0")
    b0.publish_board(16, [(0, 16)], {})
    open(os.path.join(str(tmp_path), "claim-0.1"), "w").close()
    assert b0.try_claim(0, 0, 16) is None


def test_complete_and_foreign_leases_are_immutable(tmp_path):
    b0, b1 = _board(tmp_path, "host0"), _board(tmp_path, "host1")
    b0.publish_board(16, [(0, 16)], {})
    done = b0.update(b0.try_claim(0, 0, 16, preferred_owner="host0"), n_done=16, complete=True)
    assert b1.try_claim(0, 0, 16) is None
    with pytest.raises(rs.LeaseError, match="cannot update"):
        b1.update(done, n_done=0)


def test_released_lease_is_reclaimable_without_rebalance(tmp_path):
    metrics.configure(force=True)
    b0 = _board(tmp_path, "host0", grace_s=60.0)
    b0.publish_board(16, [(0, 16)], {})
    b0.heartbeat()
    b0.update(b0.try_claim(0, 0, 16, preferred_owner="host0"), n_done=4, released=True)
    again = b0.try_claim(0, 0, 16)
    assert again is not None and again.epoch == 2 and again.n_done == 4
    assert _counter("resilience.rebalance") == 0


@pytest.mark.parametrize("writer,joiner", [(jax_rs, rs), (rs, jax_rs)])
def test_board_written_by_one_package_is_joined_by_the_other(tmp_path, writer, joiner):
    """The same board, leases and heartbeats in both packages: one
    publishes, claims and commits; the other joins, reads the lease and
    adopts the shard once the owner's heartbeat is stale."""
    ranges, ident = [(0, 8), (8, 16)], {"inputfile": "wu.bin4", "bank": "bank.dat", "n_templates": 16}
    owner = _board(tmp_path, "host1", timeout_s=0.5, mod=writer)
    owner.publish_board(16, ranges, ident)
    owner.heartbeat()
    lease = owner.update(owner.try_claim(1, 8, 16, preferred_owner="host1"), n_done=11, state_path="s.npz")
    other = _board(tmp_path, "host0", timeout_s=0.5, mod=joiner)
    assert other.publish_board(16, ranges, ident)["ranges"] == [[0, 8], [8, 16]]
    seen = other.read_lease(1)
    assert (seen.owner, seen.epoch, seen.n_done, seen.state_path) == ("host1", 1, 11, "s.npz")
    assert other.read_heartbeat("host1")["schema"] == rs.HEARTBEAT_SCHEMA
    assert other.try_claim(1, 8, 16) is None
    time.sleep(0.7)
    adopted = other.try_claim(1, 8, 16)
    assert (adopted.owner, adopted.epoch, adopted.n_done) == ("host0", 2, 11)
    assert owner.update(lease, n_done=12) is None


# ---------------------------------------------------------------------------
# shard states and the merge


def _state(seed, shape=(5, 7)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32), rng.integers(0, 99, shape).astype(np.int32)


def test_shard_state_roundtrip(tmp_path):
    lease = rs.ShardLease(1, 8, 16, "host1", 1, 12)
    M, T = _state(3)
    path = el.write_shard_state(str(tmp_path), lease, M, T, 12, 16)
    assert os.path.basename(path) == "state-s1.host1.e1.npz"
    M2, T2, doc = el.load_shard_state(path, 1, 16)
    np.testing.assert_array_equal(M, M2)
    np.testing.assert_array_equal(T, T2)
    assert doc["n_done"] == 12 and doc["owner"] == "host1" and doc["schema"] == el.SHARD_STATE_SCHEMA


@pytest.mark.parametrize("writer,reader", [(jax_el, el), (el, jax_el)])
def test_shard_state_written_by_one_package_loads_in_the_other(tmp_path, writer, reader):
    lease = writer.ShardLease(2, 16, 24, "host2", 3, 20)
    M, T = _state(4)
    path = writer.write_shard_state(str(tmp_path), lease, M, T, 20, 24)
    M2, T2, doc = reader.load_shard_state(path, 2, 24)
    np.testing.assert_array_equal(M, M2)
    np.testing.assert_array_equal(T, T2)
    assert (doc["n_done"], doc["epoch"], doc["start"], doc["stop"]) == (20, 3, 16, 24)


def test_shard_state_rejects_corruption_and_mismatch(tmp_path):
    lease = rs.ShardLease(1, 8, 16, "host1", 1, 12)
    path = el.write_shard_state(str(tmp_path), lease, np.ones((2, 3), np.float32), np.zeros((2, 3), np.int32), 12, 16)
    with pytest.raises(el.ShardStateError, match="shard 1"):
        el.load_shard_state(path, 2, 16)
    with pytest.raises(el.ShardStateError, match="different banks"):
        el.load_shard_state(path, 1, 99)
    with open(path, "ab") as f:
        f.write(b"\0")
    with pytest.raises(el.ShardStateError, match="digest mismatch"):
        el.load_shard_state(path, 1, 16)
    os.remove(path + ".json")
    with pytest.raises(el.ShardStateError, match="sidecar missing"):
        el.load_shard_state(path, 1, 16)


def test_merge_states_matches_jax():
    M1 = np.array([[2.0, 1.0, 5.0, 7.0]], dtype=np.float32)
    T1 = np.array([[3, 4, 5, 2]], dtype=np.int32)
    M2 = np.array([[2.0, 3.0, 4.0, 7.0]], dtype=np.float32)
    T2 = np.array([[1, 9, 9, 8]], dtype=np.int32)
    states = [(M1, T1), (M2, T2)] + [_state(s, (1, 4)) for s in (5, 6)]
    got, want = el.merge_states(states), jax_el.merge_states(states)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    M, T = el.merge_states([(M1, T1), (M2, T2)])
    np.testing.assert_array_equal(M, [[2.0, 3.0, 5.0, 7.0]])
    np.testing.assert_array_equal(T, [[1, 9, 5, 2]])
    again = el.merge_states([(M, T), (M1, T1), (M, T), (M2, T2)])  # idempotent
    np.testing.assert_array_equal(again[0], M)
    np.testing.assert_array_equal(again[1], T)


def test_topology_record_matches_jax():
    from boinc_app_eah_brp_tpu.io.checkpoint import topology_record as jax_topology

    ranges = dd.shard_ranges(64, 4)
    assert topology_record(4, ranges, quarantined=[(3, 5)]) == jax_topology(4, ranges, quarantined=[(3, 5)])
    assert topology_record(1) == jax_topology(1)


# ---------------------------------------------------------------------------
# run_bank_elastic in process


def _problem(n_templates=12):
    n = 2048
    ts = torch.from_numpy(synthetic_timeseries(n, f_signal=41.0, P_orb=1.9, tau=0.05, psi0=0.4, amp=6.0))
    d = DerivedParams.derive(n, 500.0, SearchConfig(window=100))
    geom = search.SearchGeometry.from_derived(d, max_slope=0.5, lut_step=0.05)
    rng = np.random.default_rng(11)
    P = np.concatenate([[1000.0], rng.uniform(1.5, 3.0, n_templates - 1)])
    tau = np.concatenate([[0.0], rng.uniform(0.0, 0.1, n_templates - 1)])
    psi = np.concatenate([[0.0], rng.uniform(0.0, 2 * np.pi, n_templates - 1)])
    return ts, geom, (P, tau, psi)


def _dist(n=2, pid=0, shard_dir=None):
    return dd.DistributedConfig(num_processes=n, process_id=pid, shard_dir=shard_dir)


@pytest.fixture
def fast_leases(monkeypatch):
    monkeypatch.setenv(rs.ENV_LEASE_TIMEOUT_S, "0.05")
    monkeypatch.setenv(rs.ENV_LEASE_GRACE_S, "0")
    monkeypatch.setenv(el.ENV_COMMIT_S, "0")
    monkeypatch.setenv(el.ENV_WAIT_S, "60")


MESH = make_mesh(devices=["cpu", "cpu"])


def _assert_reference(res, ts, geom, bank):
    M, T = search.run_bank(ts, *bank, geom, batch_size=4)
    np.testing.assert_array_equal(M.numpy(), res.state[0])
    np.testing.assert_array_equal(T.numpy(), res.state[1])


def test_elastic_sole_survivor_adopts_and_matches_reference(tmp_path, fast_leases):
    ts, geom, bank = _problem()
    metrics.configure(force=True)
    res = el.run_bank_elastic(
        ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), el.board_identity("wu", "bank", len(bank[0])),
        per_device_batch=2,
    )
    assert res.merged and not res.interrupted
    res.finalize_done()
    assert _counter("resilience.rebalance") == 1 and _counter("elastic.shards_run") == 2
    _assert_reference(res, ts, geom, bank)
    merge = rs.LeaseBoard(str(tmp_path), "host0").read_lease(rs.MERGE_SHARD)
    assert merge is not None and merge.complete


def test_elastic_adoption_revisits_exactly_uncommitted_templates(tmp_path, fast_leases, monkeypatch):
    """host1 commits [a, mid) of its shard and dies; the survivor runs its
    own shard whole and the adopted one from exactly mid."""
    ts, geom, bank = _problem()
    n = len(bank[0])
    ranges = dd.shard_ranges(n, 2)
    a, b = ranges[1]
    mid = a + (b - a) // 2
    ident = el.board_identity("wu", "bank", n)
    b1 = rs.LeaseBoard(str(tmp_path), "host1")
    b1.publish_board(n, ranges, ident)
    lease1 = b1.try_claim(1, a, b, preferred_owner="host1")
    M_part, T_part = run_bank_sharded(ts, *bank, geom, MESH, per_device_batch=2, start_template=a, stop_template=mid)
    path = el.write_shard_state(str(tmp_path), lease1, M_part.numpy(), T_part.numpy(), mid, n)
    assert b1.update(lease1, n_done=mid, state_path=path) is not None
    windows = []
    real = el.run_bank_sharded

    def spy(*args, **kw):
        windows.append((kw.get("start_template"), kw.get("stop_template")))
        return real(*args, **kw)

    monkeypatch.setattr(el, "run_bank_sharded", spy)
    time.sleep(0.12)
    res = el.run_bank_elastic(ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), ident, per_device_batch=2)
    assert res.merged
    res.finalize_done()
    assert windows == [ranges[0], (mid, b)]
    _assert_reference(res, ts, geom, bank)


def test_elastic_abandonment_never_fakes_a_complete_state(tmp_path, fast_leases):
    """A shard adopted away mid-run is abandoned without a state file that
    claims more than its owner computed; the host re-adopts it and the
    merge still matches the reference."""
    ts, geom, bank = _problem(n_templates=24)
    n = len(bank[0])
    ranges = dd.shard_ranges(n, 2)
    stolen, calls = [], []

    def steal_on_second_cb(done, total, M, T):
        calls.append(done)
        if len(calls) == 2 and not stolen:
            time.sleep(0.12)
            thief = rs.LeaseBoard(str(tmp_path), "host1")
            thief.heartbeat()
            lease = thief.try_claim(0, *ranges[0])
            assert lease is not None and lease.epoch == 2
            stolen.append(lease)
        return True

    res = el.run_bank_elastic(
        ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), el.board_identity("wu", "bank", n),
        per_device_batch=2, progress_cb=steal_on_second_cb,
    )
    assert stolen and res.merged and not res.interrupted
    res.finalize_done()
    _assert_reference(res, ts, geom, bank)
    for name in os.listdir(tmp_path):
        if name.endswith(".npz.json"):
            doc = json.load(open(os.path.join(tmp_path, name)))
            if doc["shard"] == 0 and doc["owner"] == "host0" and doc["epoch"] == 1:
                assert doc["n_done"] < ranges[0][1], name


def test_elastic_quit_releases_and_resumes(tmp_path, fast_leases):
    ts, geom, bank = _problem()
    ident = el.board_identity("wu", "bank", len(bank[0]))
    calls = []

    def quit_after_two(done, total, M, T):
        calls.append(done)
        return len(calls) < 2

    res = el.run_bank_elastic(
        ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), ident, per_device_batch=2, progress_cb=quit_after_two
    )
    assert res.interrupted and not res.merged
    lease = rs.LeaseBoard(str(tmp_path), "host0").read_lease(0)
    assert lease.released and not lease.complete
    res2 = el.run_bank_elastic(ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), ident, per_device_batch=2)
    assert res2.merged
    res2.finalize_done()
    _assert_reference(res2, ts, geom, bank)


def test_elastic_joins_a_board_the_jax_package_started(tmp_path, fast_leases):
    """The JAX package's host1 publishes the board, commits part of its
    shard with its own writer and dies; the port's host0 joins, runs its
    shard, adopts the JAX shard from its commit and merges: the port's
    run_bank state."""
    ts, geom, bank = _problem()
    n = len(bank[0])
    ranges = jax_dd.shard_ranges(n, 2)
    a, b = ranges[1]
    mid = a + 2
    ident = jax_el.board_identity("wu", "bank", n)
    jb = jax_rs.LeaseBoard(str(tmp_path), "host1")
    jb.publish_board(n, ranges, ident)
    lease = jb.try_claim(1, a, b, preferred_owner="host1")
    M_part, T_part = run_bank_sharded(ts, *bank, geom, MESH, per_device_batch=2, start_template=a, stop_template=mid)
    path = jax_el.write_shard_state(str(tmp_path), lease, M_part.numpy(), T_part.numpy(), mid, n)
    jb.update(lease, n_done=mid, state_path=path)
    time.sleep(0.12)
    res = el.run_bank_elastic(ts, *bank, geom, MESH, _dist(2, 0, str(tmp_path)), ident, per_device_batch=2)
    assert res.merged
    res.finalize_done()
    _assert_reference(res, ts, geom, bank)


# ---------------------------------------------------------------------------
# the command line: processes on one board, one killed


def _write_inputs(root, n_templates):
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(os.path.join(root, "wu.bin4"), ts, tsample_us=500.0, scale=1.0)
    rng = np.random.default_rng(7)
    P = np.concatenate([[2.2], rng.uniform(1.8, 2.6, n_templates - 1)])
    tau = np.concatenate([[0.04], rng.uniform(0.0, 0.06, n_templates - 1)])
    psi = np.concatenate([[1.2], rng.uniform(0.0, 2 * np.pi, n_templates - 1)])
    write_template_bank(os.path.join(root, "bank.dat"), TemplateBank(P, tau, psi))


def _argv(name):
    return f"-i wu.bin4 -o {name}.cand -c {name}.cpt -t bank.dat -B 200 --batch 1 --device cpu".split()


def _wait_for_commit(shard_dir, shard, proc, timeout_s):
    """Until lease-<shard>.json records committed progress inside its
    range, or the owner exits first."""
    path = os.path.join(shard_dir, f"lease-{shard}.json")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            doc = json.load(open(path))
            if not doc["complete"] and doc.get("state_path") and doc["n_done"] > doc["start"]:
                return "committed"
        except (OSError, ValueError, KeyError):
            pass
        if proc.poll() is not None:
            return "exited"
        time.sleep(0.02)
    return "timeout"


def test_cli_elastic_survivors_adopt_a_killed_process(tmp_path, monkeypatch):
    """Three ``--device cpu`` processes share one board; process 1 wedges
    after its first shard commit (an injected dispatch hang) and is
    SIGKILLed.  The survivors adopt its shard, exactly one writes the
    candidate file, and its bytes are the single-process run's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ERP_RESULT_DATE", "2026-01-01T00:00:00+00:00")
    _write_inputs(str(tmp_path), 12)
    assert main(_argv("ref")) == 0
    ref = open("ref.cand", "rb").read()
    shard_dir = str(tmp_path / "shards")
    base = dict(
        os.environ, PYTHONPATH=REPO, ERP_NUM_PROCESSES="3", ERP_SHARD_DIR=shard_dir, ERP_LEASE_TIMEOUT_S="3",
        ERP_LEASE_GRACE_S="60", ERP_SHARD_COMMIT_S="0", ERP_ELASTIC_WAIT_S="60",
    )
    procs = {}
    try:
        for h in range(3):
            env = dict(base, ERP_PROCESS_ID=str(h), ERP_METRICS_FILE=str(tmp_path / f"m{h}.jsonl"))
            if h == 1:
                env.update(ERP_FAULT_SPEC="dispatch:hang@n=2", ERP_FAULT_HANG_S="120")
            procs[h] = subprocess.Popen(
                [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *_argv(f"e{h}")], env=env, cwd=str(tmp_path),
                stdout=subprocess.DEVNULL, stderr=open(tmp_path / f"e{h}.log", "w"),
            )
        assert _wait_for_commit(shard_dir, 1, procs[1], 120) == "committed"
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        for h in (0, 2):
            assert procs[h].wait(timeout=120) == 0, open(tmp_path / f"e{h}.log").read()[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    written = [h for h in (0, 2) if os.path.exists(f"e{h}.cand")]
    assert len(written) == 1
    assert open(f"e{written[0]}.cand", "rb").read() == ref
    rebalances = 0
    for h in (0, 2):
        with open(tmp_path / f"m{h}.jsonl.report.json") as f:
            counters = json.load(f)["metrics"]["counters"]
        rebalances += (counters.get("resilience.rebalance") or {}).get("value", 0)
    assert rebalances >= 1
    # the winner's final checkpoint records the three-process layout
    cp = f"e{written[0]}.cpt"
    audit = verify_checkpoint_audit(cp, read_checkpoint(cp), process_count=3)
    assert audit["topology"]["n_shards"] == 3


def test_cli_multi_process_needs_a_shard_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_inputs(str(tmp_path), 4)
    monkeypatch.setenv(dd.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(dd.ENV_PROCESS_ID, "0")
    assert main(_argv("x")) == 4  # RADPUL_EVAL
    assert not os.path.exists("x.cand")
