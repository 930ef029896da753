"""The port's soak, bench and report tools.

Each drives the port's product paths end to end and gates what the JAX
package's tool of the same name gates, on the CPU (``--device cpu``) or
on the card (the default); the readers (``metrics_report``,
``blackbox_report``, ``fleet_timeline``, ``bench_history``,
``report_check``, ``trace_report``) put no work on a device:

* ``fabric_soak`` — the volunteer fabric against adversarial hosts,
  references from driver subprocesses or ``ERP_FABRIC_BACKEND=server``;
* ``fleet_bench`` — WUs/hour/chip of one warmed ``FleetServer`` at zero
  recompiles after warm-up;
* ``chaos_soak`` — kill/resume, host loss (``--hosts``) and hangs
  (``--hang``) against the command line;
* ``serving_chaos`` — SIGKILL, journal EIO and a dispatch wedge against
  a durable ``FleetServer``;
* ``precision_audit`` — the stage-wise audit against the f64 oracle;
* ``fleet_report`` — the ``erp-fleet-report/1`` rollup of a fabric run;
* ``report_check`` — schema checks of every artifact the port writes;
* ``bench`` — templates/s of the batched step on the JAX bench's
  production problem (one JSON line; no CPU fallback);
* ``batch_sweep`` and ``stagebench`` — the loop at a ladder of batches
  (the autobatch's artifact) and each stage of the step alone;
* ``trace_report`` — the stall table of a host trace (``ERP_TRACE_FILE``);
* ``metrics_report`` — render and ``--diff`` of run reports (its
  ``--check`` is ``report_check``);
* ``blackbox_report`` — render and ``--check`` of a flight-recorder dump;
* ``fleet_timeline`` — per-host traces, the shard board, SLO streams and
  dumps merged into one Chrome trace and its ``erp-fleet-timeline/1``
  sidecar, with its coverage and adoption gates;
* ``step_report`` — a measured run joined to the roofline per stage
  (``torch.profiler`` on the card), with its ``--diff`` and
  ``--baseline`` gates;
* ``bench_history`` — the trajectory of bench rounds, the port's bench
  lines and step reports, never across backends;
* ``smoke`` — the ``make smoke`` gate: one run with every telemetry layer
  on and its artifacts checked (``--hosts N``, ``--fabric``);
* ``golden_ref`` — ``--stages``: the f64 oracle's per-stage dump;
* ``make_app_info`` and ``make_bundle`` — the BOINC deployment bundle for
  ``sm_90a`` hosts, with the prebuilt kernel libraries.

Run one as ``python -m boinc_app_eah_brp_tpu_torch.tools.<name>``.
Importing the package loads no torch.
"""
