"""Leveled logger matching the reference's ``logMessage`` surface
(``erp_utilities.cpp:82-145``): ``[HH:MM:SS][pid][LEVEL] message`` with
error/warn/info to stderr, debug to stdout, and the ``------> ``
continuation prefix when the level tag is suppressed.  The threshold comes
from ``$ERP_LOGLEVEL`` (a name or the reference's ``-DLOGLEVEL`` number,
0 = ERROR .. 3 = DEBUG)."""

from __future__ import annotations

import os
import sys
import time
from enum import IntEnum


class Level(IntEnum):
    ERROR = 0
    WARN = 1
    INFO = 2
    DEBUG = 3


_TAGS = {
    Level.ERROR: "ERROR",
    Level.WARN: "WARN ",
    Level.INFO: "INFO ",
    Level.DEBUG: "DEBUG",
}

# threshold, like the compile-time -DLOGLEVEL (erp_utilities.cpp:39-43);
# set from $ERP_LOGLEVEL at the bottom of this module
_threshold = Level.DEBUG

# optional tap on every emitted line (the flight recorder's log-tail feed,
# runtime/flightrec.py): called with (level, formatted_line) after the
# threshold filter; it must never raise into the log path.  None = off.
_tap = None


def set_tap(fn) -> None:
    global _tap
    _tap = fn


def enabled(level: Level) -> bool:
    """Would a message at ``level`` be emitted?  Callers with costly
    message-building work (device walks) gate on this."""
    return level <= _threshold


def parse_level(raw) -> Level | None:
    """Level from a name ("info") or a number ("2"), or None when
    unparseable; numbers outside 0..3 clamp to the nearest end."""
    if isinstance(raw, Level):
        return raw
    if isinstance(raw, int):
        return Level(min(max(raw, Level.ERROR), Level.DEBUG))
    s = str(raw).strip()
    try:
        return Level(min(max(int(s), Level.ERROR), Level.DEBUG))
    except ValueError:
        pass
    try:
        return Level[s.upper()]
    except KeyError:
        return None


def log_message(level: Level, show_level: bool, msg: str, *args) -> None:
    if level > _threshold:
        return
    out = sys.stdout if level == Level.DEBUG else sys.stderr
    text = (msg % args) if args else msg
    if text.startswith("\n"):
        out.write("\n")
        if len(text) > 1:
            text = text[1:]
    if show_level:
        prefix = f"[{time.strftime('%H:%M:%S')}][{os.getpid()}][{_TAGS[level]}] "
    else:
        prefix = "------> "
    out.write(prefix)
    out.write(text)
    out.flush()
    if _tap is not None:
        try:
            _tap(level, prefix + text)
        except Exception:
            pass


def error(msg, *args):
    log_message(Level.ERROR, True, msg, *args)


def warn(msg, *args):
    log_message(Level.WARN, True, msg, *args)


def info(msg, *args):
    log_message(Level.INFO, True, msg, *args)


def debug(msg, *args):
    log_message(Level.DEBUG, True, msg, *args)


def _init_threshold_from_env() -> None:
    """$ERP_LOGLEVEL -> threshold; an invalid value falls back to DEBUG
    with a WARN line instead of failing the import."""
    global _threshold
    raw = os.environ.get("ERP_LOGLEVEL")
    if raw is None:
        return
    parsed = parse_level(raw)
    if parsed is None:
        _threshold = Level.DEBUG
        warn('Invalid ERP_LOGLEVEL "%s"; falling back to DEBUG.\n', raw)
    else:
        _threshold = parsed


_init_threshold_from_env()
