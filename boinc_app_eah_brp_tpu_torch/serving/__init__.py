"""Fleet serving tier: a resident queue-in/result-out workunit server.

See :mod:`.server` (the :class:`~.server.FleetServer` API),
:mod:`.journal` (the durable WU write-ahead log), :mod:`.slo` (the live
SLO heartbeat), :mod:`.introspect` (``/metrics``, ``/statusz``,
``/healthz``) and ``runtime/scheduler.py`` (the resident resource owner).
Importing it loads no torch.
"""

from .journal import (
    JOURNAL_SCHEMA,
    WUJournal,
    journal_path,
    replay,
    validate_journal,
)
from .server import FleetRequest, FleetServer, ServerOverloaded

__all__ = [
    "FleetRequest",
    "FleetServer",
    "ServerOverloaded",
    "JOURNAL_SCHEMA",
    "WUJournal",
    "journal_path",
    "replay",
    "validate_journal",
]
