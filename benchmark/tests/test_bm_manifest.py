"""The manifest and the data files it names: every name resolves to its
file, the files to their modules, and the manifest keeps the contract's
shape (keys, names, units, bounds, lengths)."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from bmlib import harness, inputs  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(ROOT, "BENCHMARK.json")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in manifest["command"][1:]:
        if "/" in w:
            assert any(w == p or w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        cells.append(w["name"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(cells)
    assert {w["config"] for w in manifest["workloads"]} == set(names)
    e2e = manifest["end_to_end"]
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and _line(m["layer"]) and m["moves"] in {e["name"] for e in e2e}
        moved = next(e for e in e2e if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    every = names + cells + [m["name"] for m in e2e] + [m["name"] for m in manifest["per_layer"]]
    assert all(NAME.match(n) for n in every)
    assert len(set(cells)) == len(cells) and len(set(names)) == len(names)
    assert len({m["name"] for m in e2e + manifest["per_layer"]}) == len(e2e) + len(manifest["per_layer"])


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    for w in manifest["workloads"]:
        cell = harness.Cell(manifest, w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer


def test_names_resolve_to_files_and_modules(manifest):
    for c in manifest["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/configs/")
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        inputs.geometry(cfg)
    for w in manifest["workloads"]:
        cell = harness.Cell(manifest, w["name"])
        drv = harness.load_module("drivers", cell.traffic["driver"])
        for fn in ("setup", "window", "check"):
            assert callable(getattr(drv, fn))
        assert set(cell.traffic["limits"]) and all(v >= 0 for v in cell.traffic["limits"].values())
    for m in manifest["per_layer"]:
        spec = harness.load_json(HERE, "metrics", f"{m['name']}.json")
        assert callable(harness.load_module("readers", spec["reader"]).read)


def test_file_names_under_paths_are_names(manifest):
    for base in manifest["paths"]:
        for d, _, files in os.walk(os.path.join(ROOT, base)):
            if "__pycache__" in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_an_unknown_workload_is_refused(manifest):
    with pytest.raises(SystemExit):
        harness.Cell(manifest, "no.such.cell")


def test_seeds_any_whole_number_give_the_same_inputs():
    cfg = json.load(open(os.path.join(HERE, "tests", "tiny.json")))
    for seed in (0, 7, 2**31 + 12345, 2**70 + 3, -5):
        a, b = inputs.make_problem(cfg, seed, 1), inputs.make_problem(cfg, seed, 1)
        assert (a.samples == b.samples).all() and a.inject == b.inject and (a.P == b.P).all()
    x, y = inputs.make_problem(cfg, 1), inputs.make_problem(cfg, 2)
    assert x.samples.shape == y.samples.shape and not (x.samples == y.samples).all()


def test_a_file_bank_is_the_same_for_every_seed():
    cfg = harness.load_json(HERE, "configs", "palfa200.json")
    assert all((a == b).all() for a, b in zip(inputs.make_bank(cfg, 1), inputs.make_bank(cfg, 99)))
    assert len(inputs.make_bank(cfg, 1)[0]) == cfg["templates"]
