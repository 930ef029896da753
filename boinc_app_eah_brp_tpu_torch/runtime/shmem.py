"""Screensaver shared-memory XML writer.

Byte-layout and schema compatible with ``erp_boinc_ipc.cpp:47-182``: a 1 KiB
segment holding a UTF-8 XML document

.. code-block:: xml

    <?xml version="1.0" encoding="UTF-8"?>
    <graphics_info>
      <skypos_rac>1.234</skypos_rac>
      <skypos_dec>...</skypos_dec>
      <dispersion>...</dispersion>
      <orb_radius>...</orb_radius>
      <orb_period>...</orb_period>
      <orb_phase>...</orb_phase>
      <power_spectrum>40 hex byte pairs</power_spectrum>
      <fraction_done>...</fraction_done>
      <cpu_time>...</cpu_time>
      <update_time>...</update_time>
      <boinc_status>
        <no_heartbeat>0</no_heartbeat>
        ...
      </boinc_status>
    </graphics_info>

Floats use C++ ``fixed`` with precision 3 (``erp_boinc_ipc.cpp:80``).
On Linux, BOINC graphics shmem is a file-backed mapping created by
``boinc_graphics_make_shmem(appname, size)`` under the name
``boinc_<appname>`` in the SLOT directory (the app's working directory);
screensavers attach through ``boinc_graphics_get_shmem`` by opening that
same slot-relative file (boinc/api/graphics2_unix.cpp).  The default
segment name here is therefore ``boinc_EinsteinRadio`` relative to the
cwd — the rendezvous a real BOINC graphics consumer uses; publishing is
opt-in via ``--shmem <path>`` (absolute paths override for out-of-slot
consumers).  Under the native wrapper (``native/erp_wrapper.cpp``) the
wrapper owns the segment and this writer is unused.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

ERP_SHMEM_SIZE = 1024  # erp_boinc_ipc.h:29
ERP_SHMEM_APP_NAME = "EinsteinRadio"  # erp_boinc_ipc.h:28
# the BOINC graphics API's slot-dir segment name for this app name
ERP_SHMEM_SEGMENT = f"boinc_{ERP_SHMEM_APP_NAME}"
N_BINS_SS = 40


def render_graphics_xml(info: dict) -> bytes:
    """Serialize the search-info dict to the reference XML schema."""

    def fx(key, default=0.0):
        return f"{float(info.get(key, default)):.3f}"

    spectrum = info.get("power_spectrum", b"\x00" * N_BINS_SS)
    spectrum_hex = "".join(f"{b:02x}" for b in bytes(spectrum[:N_BINS_SS]))
    status = info.get("boinc_status", {})

    def st(key):
        return str(int(status.get(key, 0)))

    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        "<graphics_info>",
        f"  <skypos_rac>{fx('skypos_rac')}</skypos_rac>",
        f"  <skypos_dec>{fx('skypos_dec')}</skypos_dec>",
        f"  <dispersion>{fx('dispersion_measure')}</dispersion>",
        f"  <orb_radius>{fx('orbital_radius')}</orb_radius>",
        f"  <orb_period>{fx('orbital_period')}</orb_period>",
        f"  <orb_phase>{fx('orbital_phase')}</orb_phase>",
        f"  <power_spectrum>{spectrum_hex}</power_spectrum>",
        f"  <fraction_done>{fx('fraction_done')}</fraction_done>",
        f"  <cpu_time>{fx('cpu_time')}</cpu_time>",
        f"  <update_time>{float(info.get('update_time', time.time())):.3f}</update_time>",
        "  <boinc_status>",
        f"    <no_heartbeat>{st('no_heartbeat')}</no_heartbeat>",
        f"    <suspended>{st('suspended')}</suspended>",
        f"    <quit_request>{st('quit_request')}</quit_request>",
        f"    <reread_init_data_file>{st('reread_init_data_file')}</reread_init_data_file>",
        f"    <abort_request>{st('abort_request')}</abort_request>",
        f"    <working_set_size>{status.get('working_set_size', 0)}</working_set_size>",
        f"    <max_working_set_size>{status.get('max_working_set_size', 0)}</max_working_set_size>",
        "  </boinc_status>",
        "</graphics_info>",
        "",
    ]
    return "\n".join(lines).encode("utf-8")


@dataclass
class ShmemWriter:
    """Writes the XML into a fixed 1 KiB zero-padded segment."""

    path: str = ERP_SHMEM_SEGMENT  # slot-relative BOINC rendezvous name
    size: int = ERP_SHMEM_SIZE
    _warned: bool = field(default=False, repr=False)

    def update(self, info: dict) -> None:
        payload = render_graphics_xml(info)
        if len(payload) >= self.size:
            if not self._warned:
                import sys

                print(
                    "Error writing shared memory data (size limit exceeded)!",
                    file=sys.stderr,
                )
                self._warned = True
            return
        buf = payload + b"\x00" * (self.size - len(payload))
        # in-place rewrite: readers mmap the segment once, so the inode must
        # never change (an os.replace would freeze every attached reader on
        # the first snapshot) — same single-buffer overwrite as the native
        # publisher (native/erp_shmem.cpp)
        try:
            with open(self.path, "r+b" if os.path.exists(self.path) else "w+b") as f:
                f.write(buf)
        except OSError:
            pass  # shmem is best-effort observability, never fail the search
