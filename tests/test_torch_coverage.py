"""The port's coverage of the JAX package, pinned.

Both packages are parsed with ``ast``; neither is imported.  For each
module of ``boinc_app_eah_brp_tpu/`` (one case each) every public
top-level function and class, and every public method of those classes,
has a same-named counterpart in the port's twin module
(``boinc_app_eah_brp_tpu_torch/`` at the same relative path), or stands
in :data:`NOT_PORTED` with one reason:

* ``TPU``: a TPU or XLA workaround on ROADMAP's "Not to port" list;
* ``ORACLE``: the test-only numpy oracle;
* ``RENAMED``: ported under another name, the port's ``module::name``
  (which must exist);
* ``REFERENCE``: waits on the reference sources;
* ``SUPERSEDED``: the port had it, and the ledger showed it no longer
  pays; the reason cites the measurement.

The same holds for every ``ERP_*`` knob the JAX package reads (a string
literal ``"ERP_*"`` in its sources): the port reads it too, or it stands
in :data:`KNOBS` (a ``RENAMED`` knob names the port's own, which the port
must read).  An entry whose name the JAX package lost, or the port
gained, fails its case too, so the tables stay exact.
"""

import ast
import functools
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "boinc_app_eah_brp_tpu"
PORT = REPO / "boinc_app_eah_brp_tpu_torch"

TPU, ORACLE, RENAMED, REFERENCE, SUPERSEDED = "tpu", "oracle", "renamed", "reference", "superseded"
KINDS = (TPU, ORACLE, RENAMED, REFERENCE, SUPERSEDED)

_PALLAS_GATE = "Pallas opt-in gate (ERP_PALLAS_*): the port always runs its CUDA kernels"
_PARITY = "parity-split operands of the TPU's packed half-length FFT: the port's kernels take the series itself"
_MXU = "the MXU matmul-cascade FFT of ops/fft.py"
_XLA_CACHE = "XLA's persistent compilation cache: the port builds its kernels into build/ or loads ERP_KERNEL_DIR"
_XPLANE = "decodes XLA's XPlane profile protos"
_LEDGER = "reads XLA's optimized HLO or AOT cost artifacts (hlo_attrib, cost_ledger)"
_OVERLAP = (
    "the background rescorer: the card's end-of-run pass scores a winner in ~10 ms "
    "(PERF_LEDGER.jsonl, rescore_s_per_wu); no card session armed it"
)

# JAX "module::name" -> (kind, the port's "module::name" for RENAMED, else the reason)
NOT_PORTED = {
    "io/checkpoint.py::empty_candidates": (RENAMED, "io/__init__.py::empty_candidates"),
    "models/search.py::SearchGeometry.parity_split": (TPU, _PARITY),
    "models/search.py::template_params_host": (RENAMED, "models/search.py::bank_params_host"),
    "models/search.py::prepare_ts": (TPU, _PARITY),
    "models/search.py::template_ps_fn": (RENAMED, "ops/spectrum.py::power_spectrum"),
    "models/search.py::template_sumspec_fn": (RENAMED, "models/search.py::template_sumspec"),
    "models/search.py::host_exact_mean_params": (RENAMED, "ops/resample.py::exact_mean_params_plain"),
    "models/search.py::use_pallas_resample": (TPU, _PALLAS_GATE),
    "models/search.py::use_pallas_resident": (TPU, _PALLAS_GATE),
    "models/search.py::resident_defers_renorm": (TPU, "defer_renorm, the resident chain's deferred whitening scale"),
    "models/search.py::use_pallas_sumspec": (TPU, _PALLAS_GATE),
    "models/search.py::make_batch_step": (RENAMED, "models/search.py::BankStep"),
    "models/search.py::bank_step_layouts": (TPU, "explicit TPU device layouts of the jitted step's operands"),
    "models/search.py::make_bank_step": (RENAMED, "models/search.py::BankStep"),
    "models/search.py::ExactMeanPrefetch": (RENAMED, "ops/resample.py::exact_mean_params"),
    "models/search.py::ExactMeanPrefetch.get": (RENAMED, "ops/resample.py::exact_mean_params"),
    "models/search.py::ExactMeanPrefetch.close": (RENAMED, "ops/resample.py::exact_mean_params"),
    "ops/fft.py::fft_plan": (TPU, _MXU),
    "ops/fft.py::cfft_split": (TPU, _MXU),
    "ops/fft.py::rfft_packed_split": (TPU, _MXU),
    "ops/fft.py::irfft_packed_split": (TPU, _MXU),
    "ops/fft.py::rfft_mxu_split": (TPU, _MXU),
    "ops/fft.py::irfft_mxu_split": (TPU, _MXU),
    "ops/fft.py::backend_has_native_fft": (TPU, _MXU),
    "ops/fft.py::rfft_split": (RENAMED, "ops/kernels.py::planned_fft"),
    "ops/fft.py::irfft_split": (RENAMED, "ops/kernels.py::planned_fft"),
    "ops/harmonic.py::harmonic_sumspec": (RENAMED, "ops/harmonic.py::sumspec_batch"),
    "ops/harmonic.py::harmonic_sumspec_batch": (RENAMED, "ops/harmonic.py::sumspec_batch"),
    "ops/native_median.py::native_available": (RENAMED, "ops/native_median.py::available"),
    "ops/native_median.py::serial_sum_f32": (RENAMED, "ops/resample.py::serial_mean_plain"),
    "ops/native_median.py::running_median_native": (RENAMED, "ops/native_median.py::running_median"),
    "ops/pallas_resample.py::pallas_applicable": (TPU, _PALLAS_GATE),
    "ops/pallas_resample.py::resample_split_pallas": (RENAMED, "ops/resample.py::resample_stream"),
    "ops/pallas_resample.py::resample_split_pallas_batch": (RENAMED, "ops/resample.py::resample_stream"),
    "ops/pallas_resample.py::resample_fftprep_pallas_batch": (RENAMED, "ops/resample.py::resample_fftprep_batch"),
    "ops/pallas_sumspec.py::sumspec_applicable": (TPU, _PALLAS_GATE),
    "ops/pallas_sumspec.py::sumspec_pallas_batch": (RENAMED, "ops/harmonic.py::sumspec_batch"),
    "ops/resample.py::resample": (RENAMED, "ops/resample.py::fftprep_series"),
    "ops/resample.py::resample_batch": (RENAMED, "ops/resample.py::resample_fftprep_batch"),
    "ops/sincos.py::blocked_lookup_supported": (
        TPU, "the LUT lookup's fixed 8-entry window of the TPU's blocked gather"
    ),
    "ops/sincos.py::sincos_lut_lookup": (RENAMED, "ops/sincos.py::sincos_lut_unwrapped"),
    "ops/sincos.py::sin_lut": (RENAMED, "ops/sincos.py::sincos_lut_unwrapped"),
    "ops/spectrum.py::power_spectrum_batch": (RENAMED, "ops/spectrum.py::power_spectrum"),
    "ops/spectrum.py::power_spectrum_split": (TPU, _PARITY),
    "ops/unpack.py::nibble_lut": (TPU, "the packed-nibble upload: the port unpacks on the host in io/workunit.py"),
    "ops/unpack.py::unpack_4bit_split_device": (
        TPU, "the packed-nibble upload: the port unpacks on the host in io/workunit.py"
    ),
    "oracle/harmonic.py::harmonic_summing_literal": (ORACLE, "hs_common.c transcribed, for the JAX tests"),
    "oracle/harmonic.py::harmonic_summing": (ORACLE, "the whole-spectrum harmonic sums of the numpy search oracle"),
    "oracle/median.py::running_median": (RENAMED, "ops/native_median.py::running_median"),
    "oracle/pipeline.py::template_sumspec": (ORACLE, "one template through the numpy search oracle"),
    "oracle/pipeline.py::run_search_oracle": (ORACLE, "the numpy whole-search oracle"),
    "oracle/pipeline.py::finalize": (RENAMED, "oracle/toplist.py::finalize_candidates"),
    "oracle/rescore.py::overlap_enabled": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer.observe": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer.observe_async": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer.finalize": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer.series_if_fetched": (SUPERSEDED, _OVERLAP),
    "oracle/rescore.py::IncrementalRescorer.abort": (SUPERSEDED, _OVERLAP),
    "oracle/spectrum.py::fft_size_for": (RENAMED, "oracle/pipeline.py::fft_size_for"),
    "oracle/toplist.py::dynamic_thresholds": (ORACLE, "the per-template toplist thresholds of the numpy search oracle"),
    "oracle/toplist.py::update_toplist_literal": (
        ORACLE, "demod_binary.c's toplist update transcribed, for the JAX tests"
    ),
    "oracle/whiten.py::whiten_and_zap": (ORACLE, "the numpy whitening oracle"),
    "parallel/sharded_search.py::make_sharded_batch_step": (RENAMED, "parallel/sharded_search.py::ShardedBankStep"),
    "runtime/cli.py::make_adapter": (RENAMED, "runtime/driver.py::make_adapter"),
    "runtime/devicecost.py::stage_of_op_name": (RENAMED, "runtime/devicecost.py::stage_of_kernel"),
    "runtime/devicecost.py::ledger_stage": (TPU, _LEDGER),
    "runtime/devicecost.py::ProfilerRecords": (TPU, _XPLANE),
    "runtime/devicecost.py::decode_profile_planes": (TPU, _XPLANE),
    "runtime/devicecost.py::parse_plane_dicts": (TPU, _XPLANE),
    "runtime/devicecost.py::stage_records": (RENAMED, "runtime/steptime.py::stage_records"),
    "runtime/devicecost.py::collect_profiler_device_records": (RENAMED, "runtime/steptime.py::capture_profile"),
    "runtime/devicecost.py::validate_hlo_attrib": (TPU, _LEDGER),
    "runtime/devicecost.py::validate_cost_ledger": (TPU, _LEDGER),
    "runtime/driver.py::default_cache_dir": (TPU, _XLA_CACHE),
    "runtime/driver.py::enable_compilation_cache": (TPU, _XLA_CACHE),
    "runtime/driver.py::touch_active_cache": (TPU, _XLA_CACHE),
    "runtime/jaxenv.py::honor_jax_platforms": (TPU, "runtime/jaxenv.py, JAX's platform selection"),
    "runtime/logging.py::route_debug_to_stderr": (RENAMED, "tools/bench.py::run_child_body"),
    "runtime/logging.py::set_level": (RENAMED, "runtime/logging.py::parse_level"),
    "runtime/logging.py::threshold": (RENAMED, "runtime/logging.py::parse_level"),
    "runtime/roofline.py::chip_generation": (RENAMED, "runtime/roofline.py::card_name"),
    "runtime/roofline.py::StageCost.t_mxu": (TPU, "the MXU's matmul time"),
    "runtime/roofline.py::StageCost.t_hbm": (RENAMED, "runtime/roofline.py::StageCost.bound"),
    "runtime/roofline.py::compiler_bound_templates_per_sec": (TPU, _LEDGER),
    "runtime/scheduler.py::StepCache.get": (RENAMED, "runtime/scheduler.py::StepCache.touch"),
    "runtime/session.py::exit_code_for": (RENAMED, "runtime/errors.py::exit_code_for"),
    "runtime/wisdom.py::warm": (TPU, "runtime/wisdom.py, XLA's compilation-cache prewarm"),
}

# the JAX package's ERP_* knobs the port does not read -> (kind, the port's knob for RENAMED, else the reason)
KNOBS = {
    "ERP_BATCH_SWEEP": (RENAMED, "ERP_TORCH_BATCH_SWEEP"),
    "ERP_COMPILATION_CACHE": (TPU, _XLA_CACHE),
    "ERP_FORCE_CASCADE": (TPU, _MXU),
    "ERP_LOOKAHEAD": (TPU, "the dispatch window: the CUDA stream queues ahead"),
    "ERP_PALLAS_INTERPRET": (TPU, _PALLAS_GATE),
    "ERP_PALLAS_RESAMPLE": (TPU, _PALLAS_GATE),
    "ERP_PALLAS_RESIDENT": (TPU, _PALLAS_GATE),
    "ERP_PALLAS_SUMSPEC": (TPU, _PALLAS_GATE),
    "ERP_RESCORE_OVERLAP": (SUPERSEDED, _OVERLAP),
}

_KNOB = re.compile(r"""(["'])(ERP_[A-Z0-9_]+)\1""")


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


@functools.cache
def public_names(path: pathlib.Path) -> tuple[str, ...]:
    """Public top-level functions and classes of ``path``, and the public
    methods of those classes as ``Class.method``."""
    if not path.is_file():
        return ()
    out = []
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [
                    f"{node.name}.{sub.name}"
                    for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and not sub.name.startswith("_")
                ]
    return out


@functools.cache
def knobs(package: pathlib.Path) -> frozenset[str]:
    """Every ``ERP_*`` string literal (the whole literal) in the package's
    sources."""
    return frozenset(m.group(2) for path in package.rglob("*.py") for m in _KNOB.finditer(path.read_text()))


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_is_ported_or_listed(module):
    jax_names = public_names(JAX / module)
    port_names = set(public_names(PORT / module))
    unlisted = [n for n in jax_names if n not in port_names and f"{module}::{n}" not in NOT_PORTED]
    assert not unlisted, f"{module}: neither in the port's twin nor in NOT_PORTED: {unlisted}"
    for key, (kind, detail) in NOT_PORTED.items():
        mod, _, name = key.partition("::")
        if mod != module:
            continue
        assert name in jax_names, f"{key}: no such public name in the JAX package"
        assert name not in port_names, f"{key}: the port's twin has it now; drop the entry"
        assert kind in KINDS and detail, key
        if kind == RENAMED:
            port_mod, _, port_name = detail.partition("::")
            assert port_name in public_names(PORT / port_mod), f"{key}: the port has no {detail}"


def test_every_table_entry_names_a_jax_module():
    listed = {key.partition("::")[0] for key in NOT_PORTED}
    assert listed <= set(JAX_MODULES), sorted(listed - set(JAX_MODULES))


def test_every_jax_knob_is_read_by_the_port_or_listed():
    jax_knobs, port_knobs = knobs(JAX), knobs(PORT)
    unlisted = sorted(k for k in jax_knobs - port_knobs if k not in KNOBS)
    assert not unlisted, f"JAX knobs the port neither reads nor lists: {unlisted}"
    for knob, (kind, detail) in KNOBS.items():
        assert knob in jax_knobs, f"{knob}: the JAX package does not read it"
        assert knob not in port_knobs, f"{knob}: the port reads it now; drop the entry"
        assert kind in KINDS and detail, knob
        if kind == RENAMED:
            assert detail in port_knobs, f"{knob}: the port does not read {detail}"


@pytest.mark.parametrize("knob", ["ERP_RESCORE", "ERP_PRECISION", "ERP_MEDIAN"])
def test_the_operator_knobs_are_read_by_the_port(knob):
    assert knob in knobs(PORT)
