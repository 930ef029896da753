"""The port's soak, bench and report tools.

Each drives the port's product paths end to end and gates what the JAX
package's tool of the same name gates, on the CPU (``--device cpu``) or
on the card (the default):

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
* ``make_app_info`` and ``make_bundle`` — the BOINC deployment bundle for
  ``sm_90a`` hosts, with the prebuilt kernel libraries.

Run one as ``python -m boinc_app_eah_brp_tpu_torch.tools.<name>``.
Importing the package loads no torch.
"""
