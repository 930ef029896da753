"""Live serving introspection plane: read-only HTTP endpoints on a
resident :class:`~.server.FleetServer`.

The SLO heartbeat stream (``serving/slo.py``) answers "how has the
server been doing" after the fact; this module answers "how is it doing
*right now*" without touching the filesystem.  Three endpoints, all
GET-only, bound to loopback:

* ``/metrics`` — the active ``runtime/metrics.py`` registry snapshot
  rendered as Prometheus text exposition (counters, numeric gauges,
  fixed-bucket histograms with cumulative ``le`` buckets, phase walls);
* ``/statusz`` — JSON: the server's ``stats()`` scoreboard, the step
  cache's resident keys, live queue depth, the durability block
  (journal depth/bytes, replayed-WU count, shed count), the watchdog's
  last-beat ages, and the SLO monitor's last emitted heartbeat plus a
  live ``peek()`` rollup;
* ``/healthz`` — 200 while healthy, **503 while the bounded queue is
  shedding** (with a ``Retry-After`` header carrying the server's
  retry-after estimate) **or whenever the SLO monitor's burn flags are
  raised** (unarmed monitors never burn).

Armed only when ``$ERP_STATUSZ_PORT`` is set (``0`` asks the kernel for
an ephemeral port — the test path); unset means the shared no-op
:data:`NULL_INTROSPECTOR` — no thread, no socket, and ``http.server``
is only imported at arm time, never at module load.  Scrapes are
read-only by construction: handlers call ``stats()``/``peek()``/
``snapshot()`` accessors and never mutate server state (``peek`` exists
precisely so scraping cannot perturb the heartbeat ``seq``).  The
loopback bind is the security boundary — exposing the port beyond the
host is an operator decision.  Introspection never
takes down serving: a bind failure degrades to the no-op with a
warning, and every handler catches into a 500.

The port's copy of the JAX package's ``serving/introspect.py``.
``/statusz`` also names the card (``device``) once the process has
initialised CUDA; like the metrics layer it never creates a context.
"""

from __future__ import annotations

import json
import os
import re
import threading

from ..runtime import metrics
from ..runtime import watchdog
from ..runtime import logging as erplog

STATUSZ_PORT_ENV = "ERP_STATUSZ_PORT"
STATUSZ_SCHEMA = "erp-statusz/1"

_BIND_HOST = "127.0.0.1"

# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


# ---------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)


def _prom_name(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _split_labels(name: str) -> tuple[str, dict]:
    """Undo ``runtime/metrics.labeled``: ``name{k=v,...}`` -> base +
    label dict.  Unlabeled names pass through."""
    if not (name.endswith("}") and "{" in name):
        return name, {}
    base, inner = name[:-1].split("{", 1)
    labels: dict = {}
    for part in inner.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k.strip()] = v.strip()
    return base, labels


def _esc(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_prom_name(k)}="{_esc(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(f) if f == f else "NaN"


def render_prometheus(snap: dict | None = None) -> str:
    """The metrics snapshot (default: the active registry's) as
    Prometheus text.  Counters gain the conventional ``_total`` suffix,
    histograms expose cumulative ``_bucket{le=...}`` series, phases
    become ``erp_phase_wall_seconds_total`` / ``erp_phase_runs_total``.
    Non-numeric gauges (provenance strings) are skipped — Prometheus
    samples are floats."""
    if snap is None:
        snap = metrics.snapshot()
    lines: list[str] = []
    typed: set[str] = set()

    def emit_type(family: str, kind: str) -> None:
        if family not in typed:
            typed.add(family)
            lines.append(f"# TYPE {family} {kind}")

    for name, c in sorted((snap.get("counters") or {}).items()):
        base, labels = _split_labels(name)
        fam = _prom_name(base)
        if not fam.endswith("_total"):
            fam += "_total"
        emit_type(fam, "counter")
        lines.append(f"{fam}{_fmt_labels(labels)} {_fmt_value(c.get('value', 0))}")

    for name, g in sorted((snap.get("gauges") or {}).items()):
        v = g.get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        base, labels = _split_labels(name)
        fam = _prom_name(base)
        emit_type(fam, "gauge")
        lines.append(f"{fam}{_fmt_labels(labels)} {_fmt_value(v)}")

    for name, h in sorted((snap.get("histograms") or {}).items()):
        base, labels = _split_labels(name)
        fam = _prom_name(base)
        emit_type(fam, "histogram")
        buckets = h.get("buckets") or []
        counts = h.get("counts") or []
        cum = 0
        for bound, n in zip(buckets, counts):
            cum += n
            lab = dict(labels)
            lab["le"] = _fmt_value(bound)
            lines.append(f"{fam}_bucket{_fmt_labels(lab)} {cum}")
        lab = dict(labels)
        lab["le"] = "+Inf"
        lines.append(
            f"{fam}_bucket{_fmt_labels(lab)} {_fmt_value(h.get('count', 0))}"
        )
        lines.append(
            f"{fam}_sum{_fmt_labels(labels)} {_fmt_value(h.get('sum', 0.0))}"
        )
        lines.append(
            f"{fam}_count{_fmt_labels(labels)} {_fmt_value(h.get('count', 0))}"
        )

    phases = snap.get("phases") or {}
    if phases:
        emit_type("erp_phase_wall_seconds_total", "counter")
        emit_type("erp_phase_runs_total", "counter")
    for name, p in sorted(phases.items()):
        lab = _fmt_labels({"phase": name})
        lines.append(
            f"erp_phase_wall_seconds_total{lab} "
            f"{_fmt_value(p.get('wall_s', 0.0))}"
        )
        lines.append(f"erp_phase_runs_total{lab} {_fmt_value(p.get('count', 0))}")

    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal exposition-format parser (samples only, labels kept in
    the key verbatim): what the tests use to prove a ``/metrics`` body
    parses."""
    out: dict[str, float] = {}
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        if not key:
            raise ValueError(f"line {lineno}: no sample value in {raw!r}")
        out[key] = float(value)
    return out


# ---------------------------------------------------------------------------
# the endpoint


class Introspector:
    """Loopback HTTP introspection endpoint over a duck-typed server
    (anything with ``stats()``, ``.slo``, ``.scheduler`` — each
    optional).  ``port=0`` binds an ephemeral port; the resolved one is
    in :attr:`port`."""

    armed = True

    def __init__(self, *, port: int, server=None, name: str = "fleet"):
        self.name = name
        self._server_ref = server
        # http.server only exists in armed processes — the disabled
        # path must not grow imports (tested like steptime/tracing)
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no stderr chatter
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except Exception as e:  # introspection never kills serving
                    try:
                        body = json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode()
                        self.send_response(500)
                        self.send_header(
                            "Content-Type", "application/json"
                        )
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((_BIND_HOST, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"erp-{name}-statusz",
            daemon=True,
        )
        self._thread.start()
        self._closed = False
        erplog.info(
            "Introspection endpoint on http://%s:%d (read-only).\n",
            _BIND_HOST, self.port,
        )

    def url(self, path: str = "/statusz") -> str:
        return f"http://{_BIND_HOST}:{self.port}{path}"

    # -- payloads (also the unit-test surface, no socket needed) ----------

    def statusz(self) -> dict:
        srv = self._server_ref
        doc: dict = {"schema": STATUSZ_SCHEMA, "name": self.name}
        if srv is not None:
            try:
                doc["stats"] = srv.stats()
            except Exception as e:
                doc["stats_error"] = f"{type(e).__name__}: {e}"
            sched = getattr(srv, "scheduler", None)
            cache = getattr(sched, "step_cache", None)
            if cache is not None:
                doc["step_cache_keys"] = sorted(
                    str(k) for k in cache.keys()
                )
            dur = getattr(srv, "durability", None)
            if callable(dur):
                # journal depth/bytes, replayed-WU count, shed count,
                # admission-control state (serving/journal.py)
                try:
                    doc["durability"] = dur()
                except Exception as e:
                    doc["durability_error"] = f"{type(e).__name__}: {e}"
        # the dispatch thread's liveness as the deadline registry sees
        # it: seconds since the last beat per in-flight stage
        doc["watchdog_beat_ages_s"] = watchdog.beat_ages()
        doc["device"] = _device_view()
        # the disabled metrics layer hands back the shared no-op
        # instrument, which has no .value
        qd = getattr(metrics.gauge("fleet.queue_depth"), "value", None)
        doc["queue_depth"] = qd if qd is not None else 0
        slo = getattr(srv, "slo", None) if srv is not None else None
        if slo is not None:
            doc["slo"] = {
                "last_heartbeat": slo.last_heartbeat(),
                "live": slo.peek(),
            }
        else:
            doc["slo"] = None
        return doc

    def healthz(self) -> tuple[int, dict]:
        srv = self._server_ref
        # admission control outranks the SLO view: while the bounded
        # queue is shedding, new submits are being rejected — tell the
        # load balancer before it sends more
        if srv is not None and getattr(srv, "shedding", False):
            doc: dict = {"status": "shedding"}
            try:
                doc["retry_after_s"] = srv.retry_after_estimate()
            except Exception:
                pass
            return 503, doc
        slo = getattr(srv, "slo", None) if srv is not None else None
        if slo is None:
            return 200, {"status": "ok", "slo": "unarmed"}
        try:
            doc = slo.peek()
        except Exception as e:
            return 200, {"status": "ok", "slo": f"peek failed: {e}"}
        flags = (doc.get("slo") or {}).get("flags") or []
        if flags:
            return 503, {"status": "burning", "flags": flags}
        return 200, {"status": "ok", "seq": doc.get("seq")}

    # -- plumbing ---------------------------------------------------------

    def _route(self, handler) -> None:
        path = handler.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
            code = 200
        elif path == "/statusz":
            body = json.dumps(self.statusz(), default=str).encode()
            ctype = "application/json"
            code = 200
        elif path == "/healthz":
            code, doc = self.healthz()
            body = json.dumps(doc).encode()
            ctype = "application/json"
            if code == 503 and doc.get("retry_after_s"):
                handler.send_response(code)
                handler.send_header(
                    "Retry-After",
                    str(int(max(1, round(doc["retry_after_s"])))),
                )
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)
                return
        else:
            body = json.dumps({"error": f"no such endpoint {path!r}"}).encode()
            ctype = "application/json"
            code = 404
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)


def _device_view() -> dict | None:
    """The card's name and the process's card count, or None when CUDA
    is not initialised (scraping never creates a context)."""
    torch = metrics._cuda_ready()
    if torch is None:
        return None
    try:
        return {
            "kind": torch.cuda.get_device_name(torch.cuda.current_device()),
            "count": torch.cuda.device_count(),
        }
    except Exception:
        return None


class _NullIntrospector:
    """Shared disabled-path stand-in: no port, no thread, close is
    free.  One instance for the whole process (identity-testable)."""

    armed = False
    port = None

    def url(self, path: str = "/statusz") -> None:
        return None

    def close(self) -> None:
        pass


NULL_INTROSPECTOR = _NullIntrospector()


def introspector_from_env(*, server=None, name: str = "fleet"):
    """The FleetServer hook: an armed endpoint when
    ``$ERP_STATUSZ_PORT`` is set (0 = ephemeral), else the shared
    no-op.  Bad ports and bind failures degrade to the no-op — the
    observatory never takes down serving."""
    raw = os.environ.get(STATUSZ_PORT_ENV)
    if raw is None or raw.strip() == "":
        return NULL_INTROSPECTOR
    try:
        port = int(raw)
    except ValueError:
        erplog.warn(
            "%s=%r is not a port; introspection stays off.\n",
            STATUSZ_PORT_ENV, raw,
        )
        return NULL_INTROSPECTOR
    try:
        return Introspector(port=port, server=server, name=name)
    except OSError as e:
        erplog.warn(
            "Introspection bind on port %d failed (%s); staying off.\n",
            port, e,
        )
        return NULL_INTROSPECTOR
