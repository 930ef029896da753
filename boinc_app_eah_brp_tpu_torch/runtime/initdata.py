"""BOINC ``init_data.xml`` parsing.

A BOINC client materializes every task in a slot directory containing
``init_data.xml`` with user/host/project details and (for GPU apps) the
device the scheduler assigned.  The reference reads it twice:

* ``boinc_get_cuda_device_id`` — ``gpu_device_num`` takes precedence over
  the ``--device`` command line (``cuda_utilities.c:44-85``);
* the result-file provenance header — userid / user_name / hostid /
  host_cpid (``demod_binary.c:1591-1602``).

This parser covers exactly those fields.  Absence of the file (standalone
runs) is not an error — the reference logs "User/host details
unavailable..." and proceeds with zeros.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from . import logging as erplog

INIT_DATA_FILE = "init_data.xml"


@dataclass
class AppInitData:
    userid: int = 0
    user_name: str | None = None
    hostid: int = 0
    host_cpid: str | None = None
    gpu_device_num: int | None = None


def _int_text(root: ET.Element, tag: str, default: int = 0) -> int:
    el = root.find(tag)
    if el is None or el.text is None:
        return default
    try:
        return int(float(el.text.strip()))
    except ValueError:
        return default


def _str_text(root: ET.Element, tag: str) -> str | None:
    el = root.find(tag)
    if el is None or el.text is None or not el.text.strip():
        return None
    return el.text.strip()


def load_init_data(directory: str = ".") -> AppInitData | None:
    """Parse ``<directory>/init_data.xml``; None when absent/unreadable
    (matching the reference's warn-and-continue,
    ``demod_binary.c:1603-1605``)."""
    path = os.path.join(directory, INIT_DATA_FILE)
    if not os.path.exists(path):
        return None
    try:
        root = ET.parse(path).getroot()
    except (ET.ParseError, OSError) as e:
        erplog.warn("Error opening or parsing %s: %s\n", path, e)
        return None

    data = AppInitData(
        userid=_int_text(root, "userid"),
        user_name=_str_text(root, "user_name"),
        hostid=_int_text(root, "hostid"),
    )
    host_info = root.find("host_info")
    if host_info is not None:
        data.host_cpid = _str_text(host_info, "host_cpid")
    gpu = root.find("gpu_device_num")
    if gpu is not None and gpu.text is not None:
        try:
            num = int(gpu.text.strip())
        except ValueError:
            num = -1
        if num >= 0:
            data.gpu_device_num = num
    return data
