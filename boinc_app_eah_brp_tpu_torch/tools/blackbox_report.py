"""Render / validate flight-recorder crash dumps (``erp-blackbox/1``):
the port's twin of the JAX package's ``tools/blackbox_report.py``, over
the port's ``runtime/flightrec.py``, with the same view of a dump written
by either package.

Companion to ``runtime/flightrec.py``: a run that died abnormally leaves
``erp-blackbox-<pid>.json`` next to its checkpoint; this tool turns the
document into the triage view — what the run was doing (dispatch window,
event ring), what it said on the way down (log tail, exception), and
where every thread stood — without the reader hand-walking JSON.

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.blackbox_report DUMP.json [DUMP2.json ...]
    python -m $T.blackbox_report --check DUMP.json    # schema gate
    python -m $T.blackbox_report --events 50 DUMP.json

The view is the JAX tool's line for line: a port dump's ``torch`` block
(the card and its memory) is not rendered, as the JAX view has no such
section.  Host code: imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..runtime.flightrec import SCHEMA, validate_dump


def _fmt_t(t, t0=None) -> str:
    if not isinstance(t, (int, float)):
        return "?"
    if t0 is not None:
        return f"{t - t0:+8.3f}s"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t))


def _fmt_bytes(n) -> str:
    if not isinstance(n, (int, float)):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:,.1f} GiB"


def _event_line(ev: dict, t0) -> str:
    extra = " ".join(
        f"{k}={v}" for k, v in ev.items() if k not in ("t", "kind")
    )
    return f"  {_fmt_t(ev.get('t'), t0)}  {ev.get('kind', '?'):<18} {extra}"


def render(doc: dict, path: str, n_events: int = 25) -> str:
    t_dump = doc.get("t")
    out = [f"== black box: {path} =="]
    out.append(
        f"reason={doc.get('reason')!r} pid={doc.get('pid')} "
        f"at {_fmt_t(t_dump)}"
    )
    argv = doc.get("argv")
    if argv:
        out.append(f"argv: {' '.join(map(str, argv))}")
    ctx = doc.get("context") or {}
    for k in sorted(ctx):
        out.append(f"  {k}: {ctx[k]}")

    exc = doc.get("exception")
    if isinstance(exc, dict):
        out.append(f"\nException: {exc.get('type')}: {exc.get('message')}")
        tb = exc.get("traceback")
        if isinstance(tb, list):
            out.append("".join(tb).rstrip())

    disp = doc.get("dispatch") or {}
    if disp:
        out.append("\nIn-flight dispatch window:")
        for k in sorted(disp):
            if k == "t":
                out.append(f"  noted: {_fmt_t(disp[k], t_dump)} before dump")
            else:
                out.append(f"  {k}: {disp[k]}")

    events = doc.get("events") or []
    if events:
        shown = events[-n_events:]
        out.append(
            f"\nEvent ring (last {len(shown)} of {len(events)}, "
            f"times relative to dump):"
        )
        out.extend(_event_line(ev, t_dump) for ev in shown)

    tail = doc.get("log_tail") or []
    if tail:
        out.append(f"\nLog tail ({len(tail)} lines):")
        out.extend(f"  {line}" for line in tail)

    jx = doc.get("jax")
    if isinstance(jx, dict):
        out.append(
            f"\nJAX: backend={jx.get('backend')} "
            f"devices={len(jx.get('devices') or [])}"
        )
        live = jx.get("live_buffers")
        if isinstance(live, dict):
            out.append(
                f"  live buffers: {live.get('count')} "
                f"({_fmt_bytes(live.get('total_bytes'))})"
            )
            for b in live.get("largest") or []:
                out.append(
                    f"    {b.get('dtype')}{b.get('shape')} "
                    f"{_fmt_bytes(b.get('nbytes'))}"
                )
        mem = jx.get("memory")
        if isinstance(mem, list):
            for dev in mem:
                if isinstance(dev, dict) and "peak_bytes_in_use" in dev:
                    out.append(
                        f"  {dev.get('device', '?')}: peak "
                        f"{_fmt_bytes(dev.get('peak_bytes_in_use'))}"
                    )

    threads = doc.get("threads") or []
    if threads:
        out.append(f"\nThreads ({len(threads)}):")
        for th in threads:
            stack = th.get("stack") or []
            top = stack[-1] if stack else {}
            out.append(
                f"  {th.get('name') or th.get('ident')}"
                f"{' (daemon)' if th.get('daemon') else ''}: "
                f"{os.path.basename(str(top.get('file', '?')))}:"
                f"{top.get('line', '?')} in {top.get('func', '?')} "
                f"[{len(stack)} frames]"
            )

    m = doc.get("metrics")
    if isinstance(m, dict):
        counters = m.get("counters") or {}
        health = {
            k: v.get("value")
            for k, v in counters.items()
            if k.startswith("health.")
        }
        if health:
            out.append("\nHealth counters at dump:")
            for k in sorted(health):
                out.append(f"  {k}: {health[k]}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render or validate erp-blackbox crash dumps."
    )
    ap.add_argument("paths", nargs="+", help="erp-blackbox-*.json dumps")
    ap.add_argument(
        "--check", action="store_true",
        help="validate each dump against the schema; exit 1 on failure",
    )
    ap.add_argument(
        "--events", type=int, default=25,
        help="how many ring events to render (default 25)",
    )
    args = ap.parse_args(argv)

    bad = 0
    for p in args.paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{p}: unreadable ({e})", file=sys.stderr)
            bad += 1
            continue
        if args.check:
            errs = validate_dump(doc)
            if errs:
                bad += 1
                print(f"{p}: INVALID")
                for e in errs:
                    print(f"  - {e}")
            else:
                print(f"{p}: OK ({SCHEMA})")
        else:
            print(render(doc, p, n_events=args.events))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
