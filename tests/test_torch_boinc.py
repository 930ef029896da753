"""PyTorch port, the BOINC adapter: the status and control files, the
screensaver segment and ``init_data.xml``, on CPU runs of the driver; the
XML and the parsed slot data against the JAX package's (exact)."""

import os

import pytest

from boinc_app_eah_brp_tpu.runtime.initdata import load_init_data as jax_load_init_data
from boinc_app_eah_brp_tpu.runtime.shmem import render_graphics_xml as jax_render
from boinc_app_eah_brp_tpu_torch.io import (
    parse_result_file,
    read_template_bank,
    write_template_bank,
    write_workunit,
)
from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint
from boinc_app_eah_brp_tpu_torch.runtime.boinc import BoincAdapter
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, device_for, make_adapter, run_search
from boinc_app_eah_brp_tpu_torch.runtime.initdata import load_init_data
from boinc_app_eah_brp_tpu_torch.runtime.session import Session
from boinc_app_eah_brp_tpu_torch.runtime.shmem import ERP_SHMEM_SIZE, render_graphics_xml
from fixtures import small_bank, synthetic_timeseries

INIT_DATA = """<app_init_data>
<userid>42</userid>
<user_name>alice</user_name>
<hostid>7</hostid>
<host_info><host_cpid>abc123</host_cpid></host_info>
<gpu_device_num>2</gpu_device_num>
</app_init_data>
"""


@pytest.fixture
def args(tmp_path):
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "test.bin4"), ts, tsample_us=500.0, scale=1.0, dm=55.5)
    write_template_bank(str(tmp_path / "bank.dat"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    return DriverArgs(
        inputfile=str(tmp_path / "test.bin4"),
        outputfile=str(tmp_path / "out.cand"),
        templatebank=str(tmp_path / "bank.dat"),
        checkpointfile=str(tmp_path / "cp.cpt"),
        window=200,
        batch_size=2,
        device="cpu",
        status_file=str(tmp_path / "status.txt"),
        control_file=str(tmp_path / "control.txt"),
    )


def test_status_file_gets_progress_and_search_info(args):
    assert run_search(args) == 0
    lines = open(args.status_file).read().splitlines()
    assert [ln for ln in lines if ln.startswith("fraction_done")] == ["fraction_done 0.500000", "fraction_done 1.000000"]
    kinds = {ln.split()[0] for ln in lines}
    assert {"skypos", "orbital", "spectrum"} <= kinds
    spectrum = next(ln for ln in lines if ln.startswith("spectrum")).split()[1]
    assert len(bytes.fromhex(spectrum)) == 40


def test_control_file_quit_checkpoints_and_exits_zero(args):
    with open(args.control_file, "w") as f:
        f.write("quit\n")
    assert run_search(args) == 0
    assert not os.path.exists(args.outputfile)
    assert read_checkpoint(args.checkpointfile).n_template == 2  # the first batch


def test_suspend_tokens_last_one_wins(tmp_path):
    control = tmp_path / "control.txt"
    adapter = BoincAdapter(control_path=str(control))
    control.write_text("suspend\n")
    assert adapter.suspended() and not adapter.quit_requested()
    control.write_text("suspend\nresume\n")
    assert not adapter.suspended()
    adapter.wait_while_suspended(poll_s=0.0)  # returns at once
    control.write_text("suspend\nabort\n")
    assert not adapter.suspended() and adapter.quit_requested()


def test_shmem_segment_holds_the_last_search_info(args, tmp_path):
    args.status_file = None
    args.shmem = str(tmp_path / "boinc_EinsteinRadio")
    assert run_search(args) == 0
    seg = open(args.shmem, "rb").read()
    assert len(seg) == ERP_SHMEM_SIZE
    xml = seg.rstrip(b"\x00").decode()
    assert xml.startswith('<?xml version="1.0" encoding="UTF-8"?>')
    last_P = read_template_bank(args.templatebank).P[-1]  # the last template searched
    assert "<fraction_done>1.000</fraction_done>" in xml and f"<orb_period>{last_P:.3f}</orb_period>" in xml


@pytest.mark.parametrize("suspended", [0, 1])
def test_graphics_xml_matches_jax(suspended):
    info = {
        "skypos_rac": 1.2345678, "skypos_dec": -0.5, "dispersion_measure": 55.5,
        "orbital_radius": 0.04, "orbital_period": 2.2, "orbital_phase": 1.2,
        "power_spectrum": bytes(range(0, 200, 5)), "fraction_done": 0.25, "cpu_time": 12.5,
        "update_time": 1760000000.125,
        "boinc_status": {"suspended": suspended, "working_set_size": 123456, "max_working_set_size": 234567},
    }
    assert render_graphics_xml(info) == jax_render(info)


def test_init_data_is_parsed_and_picks_the_card(tmp_path):
    (tmp_path / "init_data.xml").write_text(INIT_DATA)
    data = load_init_data(str(tmp_path))
    assert vars(data) == vars(jax_load_init_data(str(tmp_path)))
    assert (data.userid, data.user_name, data.hostid, data.host_cpid, data.gpu_device_num) == (
        42, "alice", 7, "abc123", 2
    )
    base = dict(inputfile="a.bin4", outputfile="o", templatebank="t")
    assert device_for(DriverArgs(**base), data) == "cuda:2"
    assert device_for(DriverArgs(device="cuda:0", **base), data) == "cuda:2"
    assert device_for(DriverArgs(device="cpu", **base), data) == "cpu"
    assert device_for(DriverArgs(device="cuda:1", **base), None) == "cuda:1"
    assert load_init_data(str(tmp_path / "missing")) is None


def test_result_header_carries_the_slot_provenance(args, tmp_path):
    (tmp_path / "init_data.xml").write_text(INIT_DATA)
    data = load_init_data(str(tmp_path))
    assert Session(args, make_adapter(args), init_data=data).run() == 0
    head = open(args.outputfile).read().splitlines()[:2]
    assert head == ["% User: 42 (alice)", "% Host: 7 (abc123)"]
    assert parse_result_file(args.outputfile).done
