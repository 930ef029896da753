"""Reduce a host span trace to a critical-path stall table.

The port's twin of the repository's ``tools/trace_report.py``, over the
trace the port's ``runtime/tracing.py`` writes (the same ``erp-trace/1``
stream and Chrome export, the same span names).  A run with
``$ERP_TRACE_FILE`` set leaves a JSONL span stream plus a Chrome trace
export (``<file>.chrome.json``); this tool loads either form and
attributes the run's wall clock to named stall categories — dispatch,
drain-stall, prefetch-wait, checkpoint, rescore-feed, retry-backoff —
using EXCLUSIVE self-time (a span's duration minus its nested children,
so the "template loop" phase bracket doesn't double-count the dispatch
windows inside it).  Background lanes (the rescorer's feed thread) are
reported separately: their busy time overlaps the main thread and is not
part of the wall-clock attribution.  Device lanes get their own section:
per-lane busy time, a per-stage breakdown, a split of the host's
drain-stall wall into device-bound time (the card was computing under the
drain) versus host-stall.  :func:`idle_gaps` names the card's longest
idle gaps, each by the innermost host span open at its middle on any
thread (the benchmark's rule for its traced breakdown,
``benchmark/bmlib/trace.py``; here with the worker threads a profiler may
not see); the text report prints them under the table.  The port's device lanes are the ``device:*
lanes of ``runtime/steptime.py`` (``device:measured``, the profiler's
kernels of the step) and ``runtime/devicecost.py``
(``device:estimated``), and the CUDA stream lanes of a PyTorch profiler
export (``stream <n>``).

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.trace_report RUN.trace.jsonl
    python -m boinc_app_eah_brp_tpu_torch.tools.trace_report RUN.trace.jsonl.chrome.json
    python -m boinc_app_eah_brp_tpu_torch.tools.trace_report --windows 5 RUN.trace.jsonl
    python -m boinc_app_eah_brp_tpu_torch.tools.trace_report --diff OLD.jsonl NEW.jsonl

``--diff`` compares the per-category self-times of two runs and exits
nonzero when a stall category regressed (default: grew by more than
25% AND 10 ms — ``--threshold`` / ``--min-delta-s`` tune it), so a CI
lane can catch e.g. a retry-backoff wall appearing between two runs.

Merged multi-pid Chrome exports are accepted too: lanes resolve per
(pid, tid), flow arrows are skipped, and the report renders one per-host
section — self-time table and coverage against that host's own span
extent — instead of conflating every host's MainThread into one lane.

Importable surface (used by ``tools/bench.py``, ``chip_smoke.py`` and the
tests): :func:`load_trace`, :func:`stall_table`, :func:`host_tables`,
:func:`window_table`, :func:`idle_gaps`, :func:`render`,
:func:`diff_tables`.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..runtime.tracing import TRACE_SCHEMA

MAIN_LANE = "MainThread"

# lanes carrying device-side records (runtime/devicecost.py): excluded
# from host wall attribution — their spans overlap the dispatch windows
# by construction — and summarized in their own section instead
DEVICE_LANE_PREFIX = "device:"
# a PyTorch profiler export names each CUDA stream's lane "stream <n>"
CUDA_STREAM_LANE_PREFIX = "stream "


def is_device_lane(tid) -> bool:
    return str(tid).startswith((DEVICE_LANE_PREFIX, CUDA_STREAM_LANE_PREFIX))

# span name -> stall category; names absent here report under their own
# name (phase brackets, setup/finalize, ...)
CATEGORY_OF = {
    "dispatch": "dispatch",
    "drain": "drain-stall",
    "prefetch-wait": "prefetch-wait",
    "checkpoint": "checkpoint",
    "ckpt-write": "checkpoint",
    "rescore-feed": "rescore-feed",
    "rescore-finalize": "rescore-feed",
    "retry-backoff": "retry-backoff",
}


def category(name: str) -> str:
    return CATEGORY_OF.get(name, name)


# ---------------------------------------------------------------------------
# loading (either artifact form -> normalized span records)


def _load_stream(lines: list[dict]) -> dict:
    spans, instants, wall_us, open_spans = [], [], None, []
    epoch = None
    for rec in lines:
        kind = rec.get("kind")
        if kind == "start":
            epoch = rec.get("epoch_unix")
        elif kind == "span":
            spans.append(rec)
        elif kind == "instant":
            instants.append(rec)
        elif kind == "finish":
            wall_us = rec.get("wall_us")
            open_spans = rec.get("open_spans") or []
    return {
        "source": "stream",
        "spans": spans,
        "instants": instants,
        "wall_us": wall_us,
        "open_spans": open_spans,
        "epoch_unix": epoch,
    }


def _load_chrome(doc: dict) -> dict:
    """Rebuild span records from B/E pairs; depth recomputed from the
    per-lane stack, lane numbers mapped back to thread names via the M
    metadata the exporter writes.

    Merged multi-pid exports carry one
    logical pid per host: lane names resolve per (pid, tid), every
    record gains the owning process's name in ``proc``, and flow arrows
    (``s``/``t``/``f``) are skipped — they link lanes, they are not
    time on any of them.  Single-pid exports load exactly as before."""
    events = [
        ev for ev in doc.get("traceEvents", []) if isinstance(ev, dict)
    ]
    lane_names: dict = {}
    proc_names: dict = {}
    pids: set = set()
    for ev in events:
        if ev.get("ph") == "M":
            name = ev.get("name")
            if name == "thread_name":
                lane_names[(ev.get("pid"), ev.get("tid"))] = (
                    ev.get("args") or {}
                ).get("name")
            elif name == "process_name":
                proc_names[ev.get("pid")] = (ev.get("args") or {}).get("name")
        elif ev.get("ph") in ("B", "E", "X", "i", "I"):
            pids.add(ev.get("pid"))
    spans, instants = [], []
    stacks: dict = {}
    for ev in events:
        ph = ev.get("ph")
        if ph in ("M", "s", "t", "f"):
            continue
        pid = ev.get("pid")
        key = (pid, ev.get("tid"))
        proc = proc_names.get(pid, f"pid{pid}")
        tid = lane_names.get(key, ev.get("tid"))
        args = dict(ev.get("args") or {})
        ctx = args.pop("ctx", None)
        if ph in ("i", "I"):
            instants.append(
                {
                    "name": ev.get("name"),
                    "tid": tid,
                    "proc": proc,
                    "ts_us": ev.get("ts"),
                    "end_us": ev.get("ts"),
                    "ctx": ctx,
                    "args": args,
                }
            )
        elif ph == "B":
            stack = stacks.setdefault(key, [])
            rec = {
                "name": ev.get("name"),
                "tid": tid,
                "proc": proc,
                "ts_us": ev.get("ts"),
                "ctx": ctx,
                "depth": len(stack),
                "args": args,
            }
            stack.append(rec)
        elif ph == "E":
            stack = stacks.get(key)
            if stack:
                rec = stack.pop()
                rec["end_us"] = ev.get("ts")
                rec["dur_us"] = max(0.0, ev.get("ts") - rec["ts_us"])
                spans.append(rec)
    other = doc.get("otherData") or {}
    return {
        "source": "chrome",
        "spans": spans,
        "instants": instants,
        "wall_us": other.get("wall_us"),
        "open_spans": [],
        "epoch_unix": other.get("epoch_unix"),
        "multi_pid": len(pids) > 1,
        "processes": sorted(
            proc_names.get(p, f"pid{p}") for p in pids
        ),
    }


def load_trace(path: str) -> dict:
    """Normalized trace from either a ``erp-trace/1`` JSONL stream or a
    Chrome trace-event export.  Raises ValueError on neither."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list):
        return _load_chrome(doc)
    lines = []
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            continue  # torn tail line of a crashed run
        if isinstance(rec, dict):
            lines.append(rec)
    if lines and lines[0].get("kind") == "start":
        if lines[0].get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"{path}: unknown trace schema {lines[0].get('schema')!r}"
            )
        return _load_stream(lines)
    raise ValueError(f"{path}: neither a trace stream nor a Chrome trace")


# ---------------------------------------------------------------------------
# attribution


def _self_times(spans: list[dict]) -> list[tuple[dict, float]]:
    """(span, exclusive self µs) per span: duration minus nested
    children, nesting decided per lane by the recorded depth (sorted by
    start, a span's parent is the nearest earlier span one level up)."""
    out = []
    by_lane: dict = {}
    for s in spans:
        by_lane.setdefault(s.get("tid"), []).append(s)
    for lane_spans in by_lane.values():
        lane_spans.sort(key=lambda s: (s.get("ts_us", 0), s.get("depth", 0)))
        stack: list[list] = []  # [span, child_us]
        for s in lane_spans:
            depth = s.get("depth", 0)
            while len(stack) > depth:
                sp, child = stack.pop()
                out.append((sp, max(0.0, sp.get("dur_us", 0.0) - child)))
            if stack:
                stack[-1][1] += s.get("dur_us", 0.0)
            stack.append([s, 0.0])
        while stack:
            sp, child = stack.pop()
            out.append((sp, max(0.0, sp.get("dur_us", 0.0) - child)))
    return out


def _union_us(spans: list[dict]) -> float:
    """Total µs covered by the union of the spans' intervals."""
    ivals = sorted(
        (s.get("ts_us", 0.0), s.get("end_us", s.get("ts_us", 0.0)))
        for s in spans
    )
    total = 0.0
    cur_a = cur_b = None
    for a, b in ivals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _intersect_us(ivals_a: list[tuple], ivals_b: list[tuple]) -> float:
    """Total µs where the two (already-merged) interval lists overlap."""
    total = 0.0
    i = j = 0
    while i < len(ivals_a) and j < len(ivals_b):
        a0, a1 = ivals_a[i]
        b0, b1 = ivals_b[j]
        lo, hi = max(a0, b0), min(a1, b1)
        if hi > lo:
            total += hi - lo
        if a1 <= b1:
            i += 1
        else:
            j += 1
    return total


def _merged(spans: list[dict]) -> list[tuple]:
    """The spans' intervals as a sorted, non-overlapping list."""
    ivals = sorted(
        (s.get("ts_us", 0.0), s.get("end_us", s.get("ts_us", 0.0)))
        for s in spans
    )
    out: list[list] = []
    for a, b in ivals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def idle_gaps(trace: dict, n: int = 10) -> list[dict]:
    """The ``n`` longest stretches between the device lanes' busy
    intervals, longest first, each named by the innermost (shortest) host
    span open at its middle on any lane, or ``host`` where none is."""
    host_spans = [s for s in trace["spans"] if not is_device_lane(s.get("tid"))]
    busy = _merged([s for s in trace["spans"] if is_device_lane(s.get("tid"))])
    out = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        around = [
            (s.get("dur_us", 0.0), str(s.get("name", "?"))) for s in host_spans
            if s.get("ts_us", 0.0) <= mid <= s.get("end_us", s.get("ts_us", 0.0))
        ]
        out.append({"s": round((b - a) / 1e6, 6), "span": min(around)[1] if around else "host"})
    return sorted(out, key=lambda g: -g["s"])[:n]


def _device_table(device_spans: list[dict], host_spans: list[dict]) -> dict:
    """The device-side summary: per-lane busy time, per-stage breakdown,
    and the drain split — how much of the host's drain-stall wall the
    card was actually computing under (device-bound) versus idle
    (host-stall: input starvation, transfer, dispatch gap)."""
    lanes: dict = {}
    stages: dict = {}
    estimated = False
    for s in device_spans:
        lanes.setdefault(s.get("tid"), []).append(s)
        name = str(s.get("name", "?"))
        if name.startswith("erp."):
            name = name[4:]
        row = stages.setdefault(name, {"busy_s": 0.0, "count": 0})
        row["busy_s"] += s.get("dur_us", 0.0) / 1e6
        row["count"] += 1
        if (s.get("args") or {}).get("estimated"):
            estimated = True
    for row in stages.values():
        row["busy_s"] = round(row["busy_s"], 6)
    busy = {tid: round(_union_us(ss) / 1e6, 6) for tid, ss in lanes.items()}
    drains = [
        s for s in host_spans
        if category(str(s.get("name", ""))) == "drain-stall"
    ]
    device_ivals = _merged(device_spans)
    drain_ivals = _merged(drains)
    drain_us = _union_us(drains)
    overlap_us = _intersect_us(device_ivals, drain_ivals)
    return {
        "estimated": estimated,
        "lane_busy_s": busy,
        "stages": stages,
        "drain_s": round(drain_us / 1e6, 6),
        "drain_device_bound_s": round(overlap_us / 1e6, 6),
        "drain_host_stall_s": round(
            max(0.0, drain_us - overlap_us) / 1e6, 6
        ),
    }


def stall_table(trace: dict) -> dict:
    """The stall-attribution summary ``tools/bench.py`` embeds and the CLI
    renders: per-category exclusive self-time on the main thread,
    coverage of the run wall, background-lane busy time, and — when the
    trace carries ``device:*`` lanes — the device-side summary."""
    device_spans = [
        s for s in trace["spans"] if is_device_lane(s.get("tid"))
    ]
    spans = [s for s in trace["spans"] if not is_device_lane(s.get("tid"))]
    wall_us = trace.get("wall_us")
    if not isinstance(wall_us, (int, float)) or wall_us <= 0:
        wall_us = max(
            (s.get("end_us", 0.0) for s in spans), default=0.0
        )  # crashed run: best effort
    main = [s for s in spans if s.get("tid") == MAIN_LANE]
    if not main and spans:
        # driver embedded differently (tests): take the busiest lane
        lanes: dict = {}
        for s in spans:
            lanes.setdefault(s.get("tid"), []).append(s)
        main_lane = max(lanes, key=lambda k: _union_us(lanes[k]))
        main = lanes[main_lane]
    else:
        main_lane = MAIN_LANE
    cats: dict = {}
    for sp, self_us in _self_times(main):
        c = category(sp.get("name", "?"))
        row = cats.setdefault(c, {"self_s": 0.0, "count": 0})
        row["self_s"] += self_us / 1e6
        row["count"] += 1
    for row in cats.values():
        row["self_s"] = round(row["self_s"], 6)
    background: dict = {}
    for s in spans:
        tid = s.get("tid")
        if tid == main_lane:
            continue
        background.setdefault(tid, []).append(s)
    background = {
        tid: round(_union_us(ss) / 1e6, 6) for tid, ss in background.items()
    }
    covered_us = _union_us([s for s in main if not s.get("depth", 0)])
    table = {
        "wall_s": round(wall_us / 1e6, 6),
        "main_lane": main_lane,
        "coverage": round(covered_us / wall_us, 4) if wall_us else 0.0,
        "categories": cats,
        "background_busy_s": background,
        "open_spans": [
            s.get("name") for s in trace.get("open_spans") or []
        ],
    }
    if device_spans:
        table["device"] = _device_table(device_spans, main)
    return table


def host_tables(trace: dict) -> list[tuple[str, dict]]:
    """Per-process stall tables for a merged multi-pid export: spans are
    split by owning process (one logical pid-lane per host in a
    merged fleet timeline), each host's wall is its own
    span extent on the shared clock, and :func:`stall_table` runs per
    host — so lanes that share a thread name across hosts (every host
    has a MainThread) never conflate."""
    by_proc: dict = {}
    for s in trace["spans"]:
        by_proc.setdefault(
            s.get("proc") or "?", {"spans": [], "instants": []}
        )["spans"].append(s)
    for i in trace["instants"]:
        by_proc.setdefault(
            i.get("proc") or "?", {"spans": [], "instants": []}
        )["instants"].append(i)
    out = []
    for proc, sub in sorted(by_proc.items()):
        recs = sub["spans"] + sub["instants"]
        first = min((r.get("ts_us", 0.0) for r in recs), default=0.0)
        last = max((r.get("end_us", 0.0) for r in recs), default=0.0)
        table = stall_table(
            {
                "source": "chrome",
                "spans": sub["spans"],
                "instants": sub["instants"],
                "wall_us": last - first if last > first else None,
                "open_spans": [],
                "epoch_unix": trace.get("epoch_unix"),
            }
        )
        out.append((proc, table))
    return out


def window_table(trace: dict, top: int) -> list[tuple]:
    """The ``top`` slowest dispatch windows: per trace-context (ctx)
    wall and per-category self-times on the main lane."""
    per_ctx: dict = {}
    host = [s for s in trace["spans"] if not is_device_lane(s.get("tid"))]
    main = [s for s in host if s.get("tid") == trace.get(
        "main_lane", MAIN_LANE)] or host
    selfs = _self_times(main)
    for sp, self_us in selfs:
        ctx = sp.get("ctx")
        if ctx is None:
            continue
        row = per_ctx.setdefault(ctx, {})
        c = category(sp.get("name", "?"))
        row[c] = row.get(c, 0.0) + self_us / 1e6
    rows = []
    for ctx, cats in per_ctx.items():
        rows.append((ctx, sum(cats.values()), cats))
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


# ---------------------------------------------------------------------------
# rendering / diff


def _table(rows: list[tuple], header: tuple) -> str:
    rows = [tuple(str(c) for c in r) for r in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(header)
    ]

    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()

    out = [line(header), line(tuple("-" * w for w in widths))]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def render(table: dict, title: str) -> str:
    out = [f"== trace report: {title} =="]
    out.append(
        f"wall {table['wall_s']:.3f} s, "
        f"{table['coverage'] * 100:.1f}% attributed on {table['main_lane']}"
    )
    if table["open_spans"]:
        out.append(f"OPEN SPANS AT EXIT: {table['open_spans']}")
    wall = table["wall_s"] or 1.0
    rows = [
        (cat, f"{row['self_s']:.3f}", f"{100 * row['self_s'] / wall:.1f}%",
         row["count"])
        for cat, row in sorted(
            table["categories"].items(), key=lambda kv: -kv[1]["self_s"]
        )
    ]
    out.append(_table(rows, ("category", "self_s", "%wall", "count")))
    if table["background_busy_s"]:
        out.append("\nBackground lanes (overlap the wall above):")
        out.append(
            _table(
                [
                    (tid, f"{busy:.3f}")
                    for tid, busy in sorted(
                        table["background_busy_s"].items()
                    )
                ],
                ("lane", "busy_s"),
            )
        )
    dev = table.get("device")
    if dev:
        tag = "estimated" if dev["estimated"] else "measured"
        out.append(f"\nDevice lanes ({tag}):")
        out.append(
            _table(
                [
                    (tid, f"{busy:.3f}")
                    for tid, busy in sorted(dev["lane_busy_s"].items())
                ],
                ("lane", "busy_s"),
            )
        )
        out.append(
            _table(
                [
                    (stage, f"{row['busy_s']:.3f}", row["count"])
                    for stage, row in sorted(
                        dev["stages"].items(),
                        key=lambda kv: -kv[1]["busy_s"],
                    )
                ],
                ("stage", "busy_s", "count"),
            )
        )
        out.append(
            f"drain split: {dev['drain_s']:.3f} s total = "
            f"{dev['drain_device_bound_s']:.3f} s device-bound + "
            f"{dev['drain_host_stall_s']:.3f} s host-stall"
        )

    return "\n".join(out)


def diff_tables(
    a: dict, b: dict, threshold_pct: float = 25.0, min_delta_s: float = 0.01
) -> list[dict]:
    """Stall categories that regressed from ``a`` to ``b``: grew by more
    than ``threshold_pct`` AND ``min_delta_s`` (absolute floor, so µs
    jitter on a near-zero category can't flag)."""
    flags = []
    cats = set(a["categories"]) | set(b["categories"])
    for cat in sorted(cats):
        va = a["categories"].get(cat, {}).get("self_s", 0.0)
        vb = b["categories"].get(cat, {}).get("self_s", 0.0)
        delta = vb - va
        if delta < min_delta_s:
            continue
        if va > 0 and delta / va * 100.0 < threshold_pct:
            continue
        flags.append(
            {
                "category": cat,
                "a_s": round(va, 6),
                "b_s": round(vb, 6),
                "delta_s": round(delta, 6),
            }
        )
    return flags


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Attribute run wall to stall categories from a host "
        "span trace (JSONL stream or Chrome export)."
    )
    ap.add_argument("paths", nargs="+", help="trace artifact path(s)")
    ap.add_argument(
        "--diff", action="store_true",
        help="compare two runs; exit 1 when a stall category regressed",
    )
    ap.add_argument(
        "--threshold", type=float, default=25.0,
        help="--diff: %% growth that counts as a regression (default 25)",
    )
    ap.add_argument(
        "--min-delta-s", type=float, default=0.01,
        help="--diff: absolute growth floor in seconds (default 0.01)",
    )
    ap.add_argument(
        "--windows", type=int, default=0, metavar="N",
        help="also show the N slowest dispatch windows by trace context",
    )
    ap.add_argument(
        "--json", action="store_true", help="emit the table(s) as JSON"
    )
    args = ap.parse_args(argv)

    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two paths")
        ta = stall_table(load_trace(args.paths[0]))
        tb = stall_table(load_trace(args.paths[1]))
        flags = diff_tables(ta, tb, args.threshold, args.min_delta_s)
        if args.json:
            print(json.dumps({"a": ta, "b": tb, "regressions": flags}))
        else:
            print(f"== trace diff: {args.paths[0]} -> {args.paths[1]} ==")
            cats = sorted(set(ta["categories"]) | set(tb["categories"]))
            rows = []
            for cat in cats:
                va = ta["categories"].get(cat, {}).get("self_s", 0.0)
                vb = tb["categories"].get(cat, {}).get("self_s", 0.0)
                mark = (
                    "REGRESSED"
                    if any(f["category"] == cat for f in flags)
                    else ""
                )
                rows.append(
                    (cat, f"{va:.3f}", f"{vb:.3f}", f"{vb - va:+.3f}", mark)
                )
            print(_table(rows, ("category", "a_s", "b_s", "delta", "")))
            for f in flags:
                print(
                    f"REGRESSION: {f['category']} "
                    f"{f['a_s']:.3f}s -> {f['b_s']:.3f}s"
                )
        return 1 if flags else 0

    rc = 0
    for p in args.paths:
        try:
            trace = load_trace(p)
        except (OSError, ValueError) as e:
            print(f"{p}: {e}", file=sys.stderr)
            rc = 1
            continue
        if trace.get("multi_pid"):
            tables = host_tables(trace)
            if args.json:
                print(json.dumps({proc: t for proc, t in tables}))
            else:
                for proc, t in tables:
                    print(render(t, f"{p} [{proc}]"))
                    print()
            continue
        table = stall_table(trace)
        if args.json:
            print(json.dumps(table))
        else:
            print(render(table, p))
            gaps = idle_gaps(trace)
            if gaps:
                print("\nLongest device idle gaps, by the host span open at each one's middle:")
                print(_table([(g["span"], f"{g['s']:.6f}") for g in gaps], ("span", "idle_s")))
        if args.windows:
            rows = [
                (
                    ctx,
                    f"{total:.3f}",
                    " ".join(
                        f"{c}={v:.3f}" for c, v in sorted(cats.items())
                    ),
                )
                for ctx, total, cats in window_table(trace, args.windows)
            ]
            print(f"\nSlowest {args.windows} windows (by trace context):")
            print(_table(rows, ("ctx", "total_s", "breakdown")))
    return rc


if __name__ == "__main__":
    sys.exit(main())
