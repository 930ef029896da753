"""Generate a BOINC ``app_info.xml`` for the port's anonymous-platform
deployment on an NVIDIA card.

The port's twin of the repository's ``tools/make_app_info.py``, with the
same :func:`render`: the native wrapper binary as the main program, the
worker zipapp and the native libraries as bundled files.  Two things
differ from the TPU bundle's file:

* the ``plan_class`` is ``cuda_sm90a``.  The reference's own
  ``debian/extra/app_info.xml.in`` is not in this repository, so the name
  follows BOINC's convention for GPU plan classes, which begin with the
  coprocessor's API (``cuda``); the suffix names the one architecture the
  shipped kernel libraries are built for (Hopper, ``sm_90a``);
* the ``app_version`` declares the coprocessor, one NVIDIA card
  (``<coproc><type>NVIDIA</type><count>1</count></coproc>``), so the client
  schedules a workunit only where a card is free.  The TPU bundle has no
  coprocessor to declare.

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.make_app_info
           [--app-name NAME] [--version N] [--wrapper PATH] [-o OUT]
"""

from __future__ import annotations

import argparse
import sys

PLAN_CLASS = "cuda_sm90a"

TEMPLATE = """<app_info>
    <app>
        <name>{app}</name>
    </app>
    <file_info>
        <name>{wrapper}</name>
        <executable/>
    </file_info>
{extra_infos}    <app_version>
        <app_name>{app}</app_name>
        <version_num>{version}</version_num>
        <avg_ncpus>1.0</avg_ncpus>
        <max_ncpus>1.0</max_ncpus>
        <plan_class>{plan_class}</plan_class>
        <coproc>
            <type>NVIDIA</type>
            <count>1</count>
        </coproc>
        <cmdline>{cmdline}</cmdline>
        <file_ref>
           <file_name>{wrapper}</file_name>
           <main_program/>
        </file_ref>
{extra_refs}    </app_version>
</app_info>
"""


def render(
    app: str,
    version: int,
    wrapper: str,
    cmdline: str,
    extra_files: list[str] | None = None,
) -> str:
    """``extra_files``: the bundled files (worker archive, native
    libraries) registered as <file_info> + <file_ref> beside the main
    program."""
    infos = "".join(
        f"    <file_info>\n        <name>{name}</name>\n    </file_info>\n"
        for name in (extra_files or [])
    )
    refs = "".join(
        "        <file_ref>\n"
        f"           <file_name>{name}</file_name>\n"
        "        </file_ref>\n"
        for name in (extra_files or [])
    )
    return TEMPLATE.format(
        app=app,
        version=version,
        wrapper=wrapper,
        cmdline=cmdline,
        plan_class=PLAN_CLASS,
        extra_infos=infos,
        extra_refs=refs,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    # the reference deployment's app name and packaged version (debian/rules:190)
    ap.add_argument("--app-name", default="einsteinbinary_BRP4")
    ap.add_argument("--version", type=int, default=56)
    ap.add_argument("--wrapper", default="erp_wrapper")
    ap.add_argument(
        "--cmdline",
        default="--worker 'python3 -m boinc_app_eah_brp_tpu_torch'",
        help="extra command line forwarded to the wrapper",
    )
    ap.add_argument("-o", "--output", default="app_info.xml")
    args = ap.parse_args(argv)
    xml = render(args.app_name, args.version, args.wrapper, args.cmdline)
    if args.output == "-":
        sys.stdout.write(xml)
    else:
        with open(args.output, "w") as f:
            f.write(xml)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
