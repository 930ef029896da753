"""Assemble one cross-host fleet timeline from a run directory's
observability artifacts: the port's twin of the JAX package's
``tools/fleet_timeline.py``, over the port's ``runtime/tracing.py``,
``runtime/resilience.py`` (the shard board), ``runtime/flightrec.py`` and
``serving/slo.py``, with the same sidecar schema, gates and output.
Host code: imports no torch.

Every layer of the observatory leaves per-process files: per-host
``erp-trace/1`` span streams (``runtime/tracing.py``), the shard lease
board's heartbeats / leases / takeover markers
(``runtime/resilience.py``), ``erp-serving-slo/1`` heartbeat streams
(``serving/slo.py``), ``erp-blackbox/1`` crash dumps
(``runtime/flightrec.py``) and the fabric's ``erp-wu-lifecycle/1``
export (``fabric/workfabric.py``).  Each is consistent on its own
clock; none shows the fleet.  This tool merges all of them into ONE
Chrome trace-event JSON (Perfetto / ``chrome://tracing`` loadable):

* one stable logical pid-lane per host/session — keyed by the stream's
  ``lane`` identity (``ERP_TRACE_LANE`` / ``host<ERP_PROCESS_ID>`` /
  correlation id), never the recyclable OS pid;
* per-host clock alignment: each stream's ``epoch_unix`` base is
  corrected by the host's lease-board heartbeat offset (the ``wall``
  the host wrote minus the shared filesystem's ``mtime`` stamp of the
  same write — ``erp-heartbeat/2``), so two hosts' spans line up on the
  board's clock even when their wall clocks disagree;
* Chrome flow arrows (``ph: "s"/"t"/"f"``) binding the host-loss story
  across lanes — host-lost detection → takeover marker (the
  ``claim-<shard>.<epoch>`` file's mtime on the board lane) → adoption
  resume — and WU issue → grant causality from the lifecycle export;
* a queryable ``erp-fleet-timeline/1`` JSON sidecar: per-host stream
  coverage fractions and clock offsets, the adoption table with
  measured latency (adoption resume minus the victim's last heartbeat),
  flow counts, and the cross-host gap table (wall intervals where no
  host produced any event).

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.fleet_timeline RUNDIR                     # assemble
    python -m $T.fleet_timeline RUNDIR --check \\
        --min-coverage 0.95 --require-adoption             # CI gate
    python -m $T.fleet_timeline SIDECAR.json --check       # re-validate
    python -m $T.fleet_timeline --diff OLD.json NEW.json

Assembly writes ``fleet-timeline.chrome.json`` and
``fleet-timeline.json`` into the run directory (``--out`` / ``--json``
override).  ``--check`` validates the merged trace with the shared
``tracing.validate_chrome`` (flow binding included), the sidecar with
:func:`validate_fleet_timeline`, and gates every *clean* host's stream
coverage (a SIGKILLed host's truncated stream is reported but never
gated — the soak kills it on purpose).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from ..fabric.workfabric import LIFECYCLE_SCHEMA
from ..runtime import flightrec, resilience
from ..runtime.tracing import TRACE_SCHEMA, validate_chrome
from ..serving.slo import SLO_SCHEMA

TIMELINE_SCHEMA = "erp-fleet-timeline/1"

CHROME_NAME = "fleet-timeline.chrome.json"
SIDECAR_NAME = "fleet-timeline.json"

_CLAIM_RE = re.compile(r"^claim-(-?\d+)\.(\d+)$")
_HOST_IN_NAME_RE = re.compile(r"(host\d+)")

# merged-trace sort rank at equal timestamps: E closes before anything
# opens (the existing single-process exporter's rule), and a flow is
# born (s) before it is stepped (t) or finished (f) — what the
# validator's binding state machine walks in list order
_PH_RANK = {"E": 0, "B": 1, "i": 1, "X": 1, "s": 2, "t": 3, "f": 4}


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _jsonl_dict_lines(path: str) -> list[dict]:
    lines: list[dict] = []
    try:
        with open(path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # torn tail of a SIGKILLed host
                if isinstance(rec, dict):
                    lines.append(rec)
    except OSError:
        return []
    return lines


def _raw_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# discovery


def discover(rundir: str) -> dict:
    """Walk ``rundir`` and classify every observability artifact by its
    self-describing schema (never by filename): per-host trace streams,
    the lease-board directory, SLO heartbeat streams, blackbox dumps and
    lifecycle exports."""
    found = {
        "traces": [],      # (path, lines)
        "board_dir": None,  # directory containing board.json
        "slo": [],         # (path, lines)
        "blackbox": [],    # (path, doc)
        "lifecycle": [],   # (path, doc)
    }
    for root, _dirs, files in os.walk(rundir):
        for name in sorted(files):
            path = os.path.join(root, name)
            if name == "board.json":
                doc = _raw_json(path)
                if (
                    isinstance(doc, dict)
                    and doc.get("schema") == resilience.BOARD_SCHEMA
                    and found["board_dir"] is None
                ):
                    found["board_dir"] = root
                continue
            if name.endswith(".jsonl"):
                lines = _jsonl_dict_lines(path)
                if not lines:
                    continue
                head = lines[0]
                if (
                    head.get("kind") == "start"
                    and head.get("schema") == TRACE_SCHEMA
                ):
                    found["traces"].append((path, lines))
                elif head.get("schema") == SLO_SCHEMA:
                    found["slo"].append((path, lines))
                continue
            if name.endswith(".json") and not name.endswith(".chrome.json"):
                doc = _raw_json(path)
                if not isinstance(doc, dict):
                    continue
                schema = doc.get("schema")
                if schema == flightrec.SCHEMA:
                    found["blackbox"].append((path, doc))
                elif schema == LIFECYCLE_SCHEMA:
                    found["lifecycle"].append((path, doc))
    return found


def _read_board(board_dir: str | None) -> dict:
    """The lease-board artifacts: per-host heartbeats (parsed through
    ``resilience.read_heartbeat``, v1 and v2), leases, and the takeover
    claim markers with their board-clock mtimes."""
    out = {"dir": board_dir, "heartbeats": {}, "leases": [], "claims": {}}
    if board_dir is None:
        return out
    for name in sorted(os.listdir(board_dir)):
        path = os.path.join(board_dir, name)
        if name.startswith("host-") and name.endswith(".hb"):
            hb = resilience.read_heartbeat(path)
            if hb is not None:
                out["heartbeats"][name[len("host-"):-len(".hb")]] = hb
            continue
        if name.startswith("lease-") and name.endswith(".json"):
            doc = _raw_json(path)
            if (
                isinstance(doc, dict)
                and doc.get("schema") == resilience.LEASE_SCHEMA
            ):
                out["leases"].append(doc)
            continue
        m = _CLAIM_RE.match(name)
        if m:
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            out["claims"][(int(m.group(1)), int(m.group(2)))] = mtime
    return out


# ---------------------------------------------------------------------------
# per-host views


class _HostView:
    """One host's parsed stream plus its alignment onto the board clock."""

    def __init__(self, path: str, lines: list[dict]):
        self.path = path
        start = lines[0]
        self.epoch_unix = float(start.get("epoch_unix") or start.get("t") or 0)
        self.name = (
            start.get("lane")
            or start.get("corr_id")
            or f"pid{start.get('pid')}"
        )
        self.records = [
            r for r in lines[1:] if r.get("kind") in ("span", "instant")
            and _is_num(r.get("ts_us")) and _is_num(r.get("end_us"))
        ]
        self.finish = (
            lines[-1] if lines[-1].get("kind") == "finish" else None
        )
        self.offset_s = 0.0
        self.offset_source = "assumed-zero"
        self.pid = 0  # logical lane pid, assigned by the assembler

    def align(self, hb: dict | None) -> None:
        """Adopt the board clock: the heartbeat's ``wall`` is this
        host's clock, its ``mtime`` the shared filesystem's stamp of the
        same write — the difference is the host's offset."""
        if hb is not None and _is_num(hb.get("wall")) and _is_num(
            hb.get("mtime")
        ):
            self.offset_s = float(hb["wall"]) - float(hb["mtime"])
            self.offset_source = "heartbeat"

    def wall(self, ts_us: float) -> float:
        """Stream-relative µs -> aligned absolute seconds."""
        return self.epoch_unix + ts_us / 1e6 - self.offset_s

    @property
    def clean(self) -> bool:
        return self.finish is not None

    def wall_us(self) -> float | None:
        if self.finish is not None and _is_num(self.finish.get("wall_us")):
            return float(self.finish["wall_us"])
        return None

    def extent_us(self) -> tuple[float, float] | None:
        if not self.records:
            return None
        first = min(r["ts_us"] for r in self.records)
        last = max(r["end_us"] for r in self.records)
        return first, last

    def coverage(self) -> float | None:
        """Fraction of the host's traced wall between its first and
        last stream event — how much of the run the merged timeline can
        actually show for this lane.  None for truncated (killed)
        streams, whose true wall is unknown."""
        wall = self.wall_us()
        ext = self.extent_us()
        if wall is None or wall <= 0 or ext is None:
            return None
        return max(0.0, min(1.0, (ext[1] - ext[0]) / wall))

    def busy_fraction(self) -> float | None:
        """Union of span intervals over the traced wall (informational
        — sparse instrumentation is not an assembly failure)."""
        wall = self.wall_us()
        if wall is None or wall <= 0:
            return None
        ivals = sorted(
            (r["ts_us"], r["end_us"])
            for r in self.records
            if r.get("kind") == "span"
        )
        busy = 0.0
        cur_a = cur_b = None
        for a, b in ivals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        return max(0.0, min(1.0, busy / wall))


def _host_views(traces: list, board: dict) -> list[_HostView]:
    views = []
    seen: dict[str, int] = {}
    for path, lines in sorted(traces):
        v = _HostView(path, lines)
        n = seen.get(v.name, 0)
        seen[v.name] = n + 1
        if n:  # two streams claiming one lane: keep both, disambiguated
            v.name = f"{v.name}#{n + 1}"
        views.append(v)
    views.sort(key=lambda v: v.name)
    for i, v in enumerate(views):
        v.pid = i + 1
        v.align(board["heartbeats"].get(v.name))
    return views


# ---------------------------------------------------------------------------
# assembly


class _Merged:
    """Accumulator for the merged trace: absolute-time events first,
    shifted onto a common zero only once everything is in."""

    def __init__(self):
        self.events: list[dict] = []  # each carries "wall" (abs seconds)
        self.meta: list[dict] = []
        self._lanes: dict[int, dict[str, int]] = {}
        self._procs: dict[int, str] = {}

    def process(self, pid: int, name: str) -> None:
        if pid not in self._procs:
            self._procs[pid] = name
            self.meta.append(
                {
                    "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": name},
                }
            )

    def lane(self, pid: int, tid_name) -> int:
        lanes = self._lanes.setdefault(pid, {})
        t = str(tid_name)
        if t not in lanes:
            lanes[t] = len(lanes) + 1
            self.meta.append(
                {
                    "ph": "M", "pid": pid, "tid": lanes[t],
                    "name": "thread_name", "args": {"name": t},
                }
            )
        return lanes[t]

    def add(self, ph: str, pid: int, tid: int, wall: float, **kw) -> None:
        self.events.append({"ph": ph, "pid": pid, "tid": tid,
                            "wall": wall, **kw})

    def render(self, other: dict) -> dict:
        t0 = min((e["wall"] for e in self.events), default=0.0)
        out = []
        for e in self.events:
            ev = dict(e)
            ev["ts"] = round((ev.pop("wall") - t0) * 1e6, 1)
            out.append(ev)
        out.sort(key=lambda e: (e["ts"], _PH_RANK.get(e["ph"], 1)))
        other = dict(other)
        other["t0_unix"] = round(t0, 6)
        return {
            "traceEvents": self.meta + out,
            "displayTimeUnit": "ms",
            "otherData": other,
        }


def _span_args(rec: dict) -> dict:
    args = dict(rec.get("args") or {})
    if rec.get("ctx") is not None:
        args["ctx"] = rec["ctx"]
    if rec.get("error"):
        args["error"] = rec["error"]
    return args


def _adoptions(
    views: list[_HostView], board: dict
) -> list[dict]:
    """The adoption table: every ``adopt`` instant in a survivor's
    stream, joined with its takeover marker (claim file mtime) and the
    victim's last heartbeat.  Latency is measured from the victim's last
    sign of life to the survivor's resume — the number the soak's
    ``--require-adoption`` gate publishes."""
    out = []
    for v in views:
        lost_by_host: dict[str, list] = {}
        for r in v.records:
            if r.get("kind") == "instant" and r.get("name") == "host-lost":
                h = (r.get("args") or {}).get("host")
                if h:
                    lost_by_host.setdefault(str(h), []).append(r)
        for r in v.records:
            if r.get("kind") != "instant" or r.get("name") != "adopt":
                continue
            args = r.get("args") or {}
            try:
                shard = int(args["shard"])
                epoch = int(args["epoch"])
            except (KeyError, TypeError, ValueError):
                continue
            from_host = str(args.get("from_host") or "?")
            t_adopt = v.wall(r["ts_us"])
            detect = None
            for cand in lost_by_host.get(from_host, []):
                if cand["ts_us"] <= r["ts_us"]:
                    detect = cand
            t_detect = v.wall(detect["ts_us"]) if detect else None
            t_takeover = board["claims"].get((shard, epoch))
            hb = board["heartbeats"].get(from_host)
            t_lost = hb["mtime"] if hb else t_detect
            out.append(
                {
                    "shard": shard,
                    "epoch": epoch,
                    "from_host": from_host,
                    "to_host": v.name,
                    "t_detect_unix": (
                        round(t_detect, 6) if t_detect is not None else None
                    ),
                    "t_takeover_unix": (
                        round(t_takeover, 6)
                        if t_takeover is not None else None
                    ),
                    "t_adopt_unix": round(t_adopt, 6),
                    "latency_s": (
                        round(t_adopt - t_lost, 6)
                        if t_lost is not None else None
                    ),
                    "flow_id": f"adopt-{shard}-e{epoch}",
                    "_view": v,
                    "_adopt_rec": r,
                    "_detect_rec": detect,
                }
            )
    out.sort(key=lambda a: a["t_adopt_unix"])
    return out


def _fleet_gaps(
    views: list[_HostView], threshold_s: float
) -> tuple[list[dict], dict[str, float]]:
    """Cross-host gap table: aligned wall intervals where NO host
    produced any stream event, longer than ``threshold_s``; plus each
    host's own largest internal gap."""
    per_host_max: dict[str, float] = {}
    all_times: list[float] = []
    for v in views:
        times: list[float] = []
        for r in v.records:
            times.append(v.wall(r["ts_us"]))
            times.append(v.wall(r["end_us"]))
        times.sort()
        if len(times) >= 2:
            per_host_max[v.name] = round(
                max(b - a for a, b in zip(times, times[1:])), 6
            )
        elif times:
            per_host_max[v.name] = 0.0
        all_times.extend(times)
    all_times.sort()
    gaps = [
        {"after_unix": round(a, 6), "duration_s": round(b - a, 6)}
        for a, b in zip(all_times, all_times[1:])
        if b - a > threshold_s
    ]
    return gaps, per_host_max


def assemble(rundir: str, gap_threshold_s: float = 0.25) -> tuple[dict, dict]:
    """(merged chrome doc, erp-fleet-timeline/1 sidecar) for one run
    directory."""
    found = discover(rundir)
    board = _read_board(found["board_dir"])
    views = _host_views(found["traces"], board)
    merged = _Merged()
    next_pid = len(views) + 1

    # -- host lanes
    for v in views:
        merged.process(v.pid, f"erp-search:{v.name}")
        for r in v.records:
            tid = merged.lane(v.pid, r.get("tid", "?"))
            base = {"name": r["name"], "cat": "erp", "args": _span_args(r)}
            if r["kind"] == "instant":
                merged.add(
                    "i", v.pid, tid, v.wall(r["ts_us"]), s="t", **base
                )
            else:
                merged.add("B", v.pid, tid, v.wall(r["ts_us"]), **base)
                merged.add(
                    "E", v.pid, tid, v.wall(r["end_us"]), name=r["name"]
                )

    # -- lease-board lane: takeover/claim markers at their mtimes
    board_pid = None
    if board["dir"] is not None:
        board_pid = next_pid
        next_pid += 1
        merged.process(board_pid, "lease-board")
        btid = merged.lane(board_pid, "claims")
        for (shard, epoch), mtime in sorted(board["claims"].items()):
            kind = "takeover" if epoch > 1 else "claim"
            merged.add(
                "i", board_pid, btid, mtime, s="t",
                name=f"{kind}:shard{shard}@e{epoch}", cat="erp",
                args={"shard": shard, "epoch": epoch},
            )

    # -- serving SLO heartbeat lanes
    for path, lines in sorted(found["slo"]):
        pid = next_pid
        next_pid += 1
        stem = os.path.splitext(os.path.basename(path))[0]
        merged.process(pid, f"serving-slo:{stem}")
        tid = merged.lane(pid, "heartbeats")
        for doc in lines:
            if not _is_num(doc.get("t")):
                continue
            merged.add(
                "i", pid, tid, float(doc["t"]), s="t", name="slo-heartbeat",
                cat="erp",
                args={
                    "seq": doc.get("seq"),
                    "burning": bool((doc.get("slo") or {}).get("burning")),
                    "queue_depth": doc.get("queue_depth"),
                },
            )

    # -- blackbox dumps: flight-recorder events onto the crashed host's
    # lane when the filename names it, else their own lane
    by_name = {v.name: v for v in views}
    for path, doc in sorted(found["blackbox"]):
        m = _HOST_IN_NAME_RE.search(os.path.basename(path))
        host = by_name.get(m.group(1)) if m else None
        if host is not None:
            pid, off = host.pid, host.offset_s
        else:
            pid, off = next_pid, 0.0
            next_pid += 1
            merged.process(
                pid, f"blackbox:{os.path.splitext(os.path.basename(path))[0]}"
            )
        tid = merged.lane(pid, "flightrec")
        for ev in flightrec.events_from_dump(doc):
            args = {
                k: v for k, v in ev.items() if k not in ("t", "kind")
            }
            merged.add(
                "i", pid, tid, float(ev["t"]) - off, s="t",
                name=f"fr:{ev['kind']}", cat="erp", args=args,
            )

    # -- adoption flow chains: host-lost (s) -> takeover marker (t) ->
    # adoption resume (f).  The claim file is created moments BEFORE the
    # survivor records the detection, so the flow step clamps forward —
    # the takeover *marker* instant above keeps its true mtime
    adoptions = _adoptions(views, board)
    for a in adoptions:
        v = a.pop("_view")
        adopt_rec = a.pop("_adopt_rec")
        detect_rec = a.pop("_detect_rec")
        fid = a["flow_id"]
        adopt_tid = merged.lane(v.pid, adopt_rec.get("tid", "?"))
        if detect_rec is not None:
            s_pid = v.pid
            s_tid = merged.lane(v.pid, detect_rec.get("tid", "?"))
            s_wall = v.wall(detect_rec["ts_us"])
        else:  # legacy stream without the detection instant
            s_pid, s_tid = v.pid, adopt_tid
            s_wall = a["t_adopt_unix"] - 1e-6
        merged.add(
            "s", s_pid, s_tid, s_wall, name="adoption", cat="erp-flow",
            id=fid,
        )
        cursor = s_wall
        if board_pid is not None and a["t_takeover_unix"] is not None:
            cursor = max(cursor, a["t_takeover_unix"])
            merged.add(
                "t", board_pid, merged.lane(board_pid, "claims"), cursor,
                name="adoption", cat="erp-flow", id=fid,
            )
        merged.add(
            "f", v.pid, adopt_tid,
            max(cursor, v.wall(adopt_rec["ts_us"])),
            name="adoption", cat="erp-flow", id=fid, bp="e",
        )
        a["to_host"] = v.name

    # -- WU issue -> grant flows from the lifecycle export
    wu_flows = 0
    for path, doc in sorted(found["lifecycle"]):
        pid = next_pid
        next_pid += 1
        merged.process(pid, "work-fabric")
        tid = merged.lane(pid, "wu-lifecycle")
        for wu in doc.get("wus") or []:
            issued, granted = wu.get("issued_unix"), wu.get("granted_unix")
            if not (_is_num(issued) and _is_num(granted)):
                continue
            wu_id = wu.get("wu_id", "?")
            fid = f"wu-{wu_id}"
            merged.add(
                "i", pid, tid, float(issued), s="t", name=f"issue:{wu_id}",
                cat="erp", args={"corr_id": wu.get("corr_id")},
            )
            winner = by_name.get(f"host{wu.get('winner_host')}")
            g_pid = winner.pid if winner is not None else pid
            g_tid = (
                merged.lane(g_pid, "wu-grant") if winner is not None else tid
            )
            merged.add(
                "i", g_pid, g_tid, float(granted), s="t",
                name=f"grant:{wu_id}", cat="erp",
                args={"latency_s": wu.get("grant_latency_s")},
            )
            merged.add(
                "s", pid, tid, float(issued), name="wu-grant",
                cat="erp-flow", id=fid,
            )
            merged.add(
                "f", g_pid, g_tid, max(float(issued), float(granted)),
                name="wu-grant", cat="erp-flow", id=fid, bp="e",
            )
            wu_flows += 1

    gaps, per_host_max_gap = _fleet_gaps(views, gap_threshold_s)

    hosts_doc = {}
    for v in views:
        ext = v.extent_us()
        wall_us = v.wall_us()
        cov = v.coverage()
        hosts_doc[v.name] = {
            "lane": v.name,
            "pid": v.pid,
            "stream": os.path.relpath(v.path, rundir),
            "clean": v.clean,
            "exit_status": (
                v.finish.get("exit_status") if v.finish is not None else None
            ),
            "events": len(v.records),
            "spans": sum(1 for r in v.records if r["kind"] == "span"),
            "wall_s": (
                round(wall_us / 1e6, 6) if wall_us is not None else None
            ),
            "coverage": round(cov, 6) if cov is not None else None,
            "busy_fraction": (
                round(v.busy_fraction(), 6)
                if v.busy_fraction() is not None else None
            ),
            "clock_offset_s": round(v.offset_s, 6),
            "offset_source": v.offset_source,
            "heartbeat_schema": (
                board["heartbeats"][v.name]["schema"]
                if v.name in board["heartbeats"] else None
            ),
            "first_unix": (
                round(v.wall(ext[0]), 6) if ext is not None else None
            ),
            "last_unix": (
                round(v.wall(ext[1]), 6) if ext is not None else None
            ),
            "max_gap_s": per_host_max_gap.get(v.name),
        }

    clean = [h for h in hosts_doc.values() if h["clean"]]
    coverages = [
        h["coverage"] for h in clean if h["coverage"] is not None
    ]
    sidecar = {
        "schema": TIMELINE_SCHEMA,
        "t": time.time(),
        "run_dir": os.path.abspath(rundir),
        "hosts": hosts_doc,
        "board": {
            "dir": (
                os.path.relpath(board["dir"], rundir)
                if board["dir"] else None
            ),
            "heartbeats": {
                h: {
                    "schema": hb["schema"],
                    "wall": round(hb["wall"], 6),
                    "mtime": round(hb["mtime"], 6),
                    "offset_s": round(hb["wall"] - hb["mtime"], 6),
                }
                for h, hb in sorted(board["heartbeats"].items())
            },
            "leases": len(board["leases"]),
            "takeovers": sum(
                1 for (_s, e) in board["claims"] if e > 1
            ),
        },
        "adoptions": adoptions,
        "flows": {"adoption": len(adoptions), "wu_grant": wu_flows},
        "gaps": gaps,
        "gap_threshold_s": gap_threshold_s,
        "summary": {
            "hosts": len(views),
            "clean_hosts": len(clean),
            "events": sum(len(v.records) for v in views),
            "slo_streams": len(found["slo"]),
            "blackbox_dumps": len(found["blackbox"]),
            "lifecycle_exports": len(found["lifecycle"]),
            "adoptions": len(adoptions),
            "min_coverage": (
                round(min(coverages), 6) if coverages else None
            ),
        },
    }
    chrome = merged.render(
        {
            "schema": TIMELINE_SCHEMA,
            "hosts": [v.name for v in views],
            "adoption_flows": len(adoptions),
            "wu_flows": wu_flows,
        }
    )
    return chrome, sidecar


# ---------------------------------------------------------------------------
# validation (shared by tools/report_check.py)


def validate_fleet_timeline(doc) -> list[str]:
    """Structural check of an ``erp-fleet-timeline/1`` sidecar; returns
    a list of problems (empty = valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != TIMELINE_SCHEMA:
        errs.append(
            f"schema is {doc.get('schema')!r}, expected {TIMELINE_SCHEMA!r}"
        )
    if not _is_num(doc.get("t")):
        errs.append("missing numeric t")
    hosts = doc.get("hosts")
    if not isinstance(hosts, dict) or not hosts:
        errs.append("hosts missing or empty")
        hosts = {}
    for name, h in hosts.items():
        if not isinstance(h, dict):
            errs.append(f"host {name}: not an object")
            continue
        if not isinstance(h.get("clean"), bool):
            errs.append(f"host {name}: missing boolean clean")
        if not isinstance(h.get("events"), int) or h.get("events", -1) < 0:
            errs.append(f"host {name}: missing nonnegative events")
        cov = h.get("coverage")
        if cov is not None and (not _is_num(cov) or not 0 <= cov <= 1):
            errs.append(f"host {name}: coverage {cov!r} outside [0, 1]")
        if h.get("clean") and cov is None and h.get("events", 0) > 0:
            errs.append(f"host {name}: clean with events but no coverage")
        if not _is_num(h.get("clock_offset_s")):
            errs.append(f"host {name}: missing numeric clock_offset_s")
        if h.get("offset_source") not in ("heartbeat", "assumed-zero"):
            errs.append(
                f"host {name}: bad offset_source "
                f"{h.get('offset_source')!r}"
            )
    adoptions = doc.get("adoptions")
    if not isinstance(adoptions, list):
        errs.append("adoptions missing or not a list")
        adoptions = []
    for i, a in enumerate(adoptions):
        if not isinstance(a, dict):
            errs.append(f"adoption {i}: not an object")
            continue
        for key in ("shard", "epoch"):
            if not isinstance(a.get(key), int):
                errs.append(f"adoption {i}: missing integer {key}")
        for key in ("from_host", "to_host", "flow_id"):
            if not a.get(key) or not isinstance(a.get(key), str):
                errs.append(f"adoption {i}: missing {key}")
        if not _is_num(a.get("t_adopt_unix")):
            errs.append(f"adoption {i}: missing numeric t_adopt_unix")
        lat = a.get("latency_s")
        if lat is not None and (not _is_num(lat) or lat < 0):
            errs.append(f"adoption {i}: latency_s {lat!r} not >= 0")
    flows = doc.get("flows")
    if not isinstance(flows, dict):
        errs.append("flows missing or not an object")
    else:
        for key in ("adoption", "wu_grant"):
            if not isinstance(flows.get(key), int) or flows[key] < 0:
                errs.append(f"flows.{key} missing or negative")
        if isinstance(flows.get("adoption"), int) and flows[
            "adoption"
        ] != len(adoptions):
            errs.append(
                f"flows.adoption {flows['adoption']} != "
                f"{len(adoptions)} adoption entries"
            )
    gaps = doc.get("gaps")
    if not isinstance(gaps, list):
        errs.append("gaps missing or not a list")
    else:
        for i, g in enumerate(gaps):
            if not isinstance(g, dict) or not _is_num(
                g.get("after_unix")
            ) or not _is_num(g.get("duration_s")) or g["duration_s"] <= 0:
                errs.append(f"gap {i}: needs after_unix + positive duration_s")
    summary = doc.get("summary")
    if not isinstance(summary, dict):
        errs.append("summary missing or not an object")
    else:
        if summary.get("hosts") != len(hosts):
            errs.append(
                f"summary.hosts {summary.get('hosts')!r} != "
                f"{len(hosts)} host entries"
            )
        if summary.get("adoptions") != len(adoptions):
            errs.append(
                f"summary.adoptions {summary.get('adoptions')!r} != "
                f"{len(adoptions)} adoption entries"
            )
    return errs


# ---------------------------------------------------------------------------
# gates, rendering, CLI


def check_gates(
    sidecar: dict, min_coverage: float, require_adoption: bool
) -> list[str]:
    """The CI acceptance gates, over and above structural validity:
    every clean host's stream coverage >= the floor, and (optionally) at
    least one adoption with a measured latency."""
    errs: list[str] = []
    hosts = sidecar.get("hosts") or {}
    clean = {n: h for n, h in hosts.items() if h.get("clean")}
    if not clean:
        errs.append("no host exited cleanly — nothing to gate coverage on")
    for name, h in sorted(clean.items()):
        cov = h.get("coverage")
        if cov is None:
            errs.append(f"host {name}: clean but no coverage computed")
        elif cov < min_coverage:
            errs.append(
                f"host {name}: stream coverage {cov:.4f} under the "
                f"{min_coverage:.2f} floor"
            )
    if require_adoption:
        adoptions = sidecar.get("adoptions") or []
        measured = [
            a for a in adoptions if _is_num(a.get("latency_s"))
        ]
        if not adoptions:
            errs.append(
                "no adoption recorded — the host-lost -> takeover -> "
                "adoption chain is missing from the timeline"
            )
        elif not measured:
            errs.append(
                "adoptions recorded but none carries a measured latency_s"
            )
    return errs


def _fmt(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:,.4f}".rstrip("0").rstrip(".")
    return str(v)


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


def render(sidecar: dict, title: str) -> str:
    out = [f"== fleet timeline: {title} =="]
    hosts = sidecar.get("hosts") or {}
    out.append(
        _table(
            [
                (
                    name, h.get("pid"), _fmt(h.get("events")),
                    _fmt(h.get("wall_s")), _fmt(h.get("coverage")),
                    _fmt(h.get("clock_offset_s")),
                    "clean" if h.get("clean") else "TRUNCATED",
                )
                for name, h in sorted(hosts.items())
            ],
            ("host", "pid", "events", "wall_s", "coverage", "offset_s",
             "exit"),
        )
    )
    adoptions = sidecar.get("adoptions") or []
    if adoptions:
        out.append("\nAdoptions:")
        out.append(
            _table(
                [
                    (
                        a.get("shard"), a.get("epoch"),
                        f"{a.get('from_host')} -> {a.get('to_host')}",
                        _fmt(a.get("latency_s")),
                    )
                    for a in adoptions
                ],
                ("shard", "epoch", "path", "latency_s"),
            )
        )
    gaps = sidecar.get("gaps") or []
    s = sidecar.get("summary") or {}
    out.append(
        f"\n{s.get('hosts')} hosts ({s.get('clean_hosts')} clean), "
        f"{s.get('events')} events, {s.get('adoptions')} adoptions, "
        f"{len(gaps)} cross-host gaps > "
        f"{_fmt(sidecar.get('gap_threshold_s'))}s"
    )
    return "\n".join(out)


def diff_sidecars(a: dict, b: dict, a_name: str, b_name: str) -> str:
    rows = []
    hosts = sorted(set(a.get("hosts") or {}) | set(b.get("hosts") or {}))
    for name in hosts:
        ha = (a.get("hosts") or {}).get(name) or {}
        hb = (b.get("hosts") or {}).get(name) or {}
        rows.append(
            (
                f"coverage:{name}", _fmt(ha.get("coverage")),
                _fmt(hb.get("coverage")),
            )
        )
        rows.append(
            (
                f"offset_s:{name}", _fmt(ha.get("clock_offset_s")),
                _fmt(hb.get("clock_offset_s")),
            )
        )

    def _lat(doc):
        lats = [
            x["latency_s"] for x in (doc.get("adoptions") or [])
            if _is_num(x.get("latency_s"))
        ]
        return round(sum(lats) / len(lats), 6) if lats else None

    rows.append(("adoptions", _fmt((a.get("summary") or {}).get("adoptions")),
                 _fmt((b.get("summary") or {}).get("adoptions"))))
    rows.append(("mean_adoption_latency_s", _fmt(_lat(a)), _fmt(_lat(b))))
    rows.append(("gaps", _fmt(len(a.get("gaps") or [])),
                 _fmt(len(b.get("gaps") or []))))
    return "\n".join(
        [f"== fleet-timeline diff: {a_name} -> {b_name} ==",
         _table(rows, ("metric", "a", "b"))]
    )


def _write_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=(
            "Merge a run directory's per-host observability artifacts "
            "into one Chrome trace + queryable sidecar."
        )
    )
    ap.add_argument(
        "paths", nargs="+",
        help="run directory to assemble, or erp-fleet-timeline/1 sidecar",
    )
    ap.add_argument("--out", help="merged Chrome trace output path")
    ap.add_argument("--json", dest="json_out", help="sidecar output path")
    ap.add_argument(
        "--check", action="store_true",
        help="validate trace + sidecar and apply the gates; exit 1 on fail",
    )
    ap.add_argument(
        "--min-coverage", type=float, default=0.0,
        help="per-clean-host stream coverage floor (with --check)",
    )
    ap.add_argument(
        "--require-adoption", action="store_true",
        help="--check fails unless an adoption with measured latency exists",
    )
    ap.add_argument(
        "--gap-threshold", type=float, default=0.25,
        help="cross-host gap table threshold in seconds (default 0.25)",
    )
    ap.add_argument(
        "--diff", action="store_true", help="diff two sidecars"
    )
    args = ap.parse_args(argv)

    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two sidecar paths")
        docs = []
        for p in args.paths:
            doc = _raw_json(p)
            if not isinstance(doc, dict) or doc.get(
                "schema"
            ) != TIMELINE_SCHEMA:
                print(f"{p}: not an {TIMELINE_SCHEMA} sidecar",
                      file=sys.stderr)
                return 1
            docs.append(doc)
        print(diff_sidecars(docs[0], docs[1], *args.paths))
        return 0

    if (args.out or args.json_out) and len(args.paths) != 1:
        ap.error("--out/--json apply to exactly one run directory")

    bad = 0
    for p in args.paths:
        if os.path.isdir(p):
            chrome, sidecar = assemble(p, gap_threshold_s=args.gap_threshold)
            out_path = args.out or os.path.join(p, CHROME_NAME)
            json_path = args.json_out or os.path.join(p, SIDECAR_NAME)
            _write_json(out_path, chrome)
            _write_json(json_path, sidecar)
            print(render(sidecar, p))
            print(f"\nwrote {out_path}\nwrote {json_path}")
            errs = []
            if args.check:
                errs += [f"chrome: {e}" for e in validate_chrome(chrome)]
                errs += [
                    f"sidecar: {e}"
                    for e in validate_fleet_timeline(sidecar)
                ]
                errs += check_gates(
                    sidecar, args.min_coverage, args.require_adoption
                )
        else:
            doc = _raw_json(p)
            if not isinstance(doc, dict) or doc.get(
                "schema"
            ) != TIMELINE_SCHEMA:
                print(f"{p}: not an {TIMELINE_SCHEMA} sidecar",
                      file=sys.stderr)
                bad += 1
                continue
            errs = []
            if args.check:
                errs += validate_fleet_timeline(doc)
                errs += check_gates(
                    doc, args.min_coverage, args.require_adoption
                )
            else:
                print(render(doc, p))
        if args.check:
            if errs:
                bad += 1
                print(f"{p}: INVALID")
                for e in errs:
                    print(f"  - {e}")
            else:
                print(f"{p}: OK ({TIMELINE_SCHEMA})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
