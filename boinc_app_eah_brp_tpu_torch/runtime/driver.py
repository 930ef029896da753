"""The search driver: read the workunit and bank, whiten, search, write
the candidate file (the reference's ``MAIN()``, ``demod_binary.c:117``).

This slice runs whitened searches from scratch to a result file.  Options
it does not honour yet (checkpointing, unwhitened runs, rescoring, BOINC
and screensaver integration) raise instead of being ignored.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..io import (
    ResultFile,
    ResultHeader,
    TemplateBank,
    TemplateBankError,
    empty_candidates,
    read_template_bank,
    read_workunit,
    read_zaplist,
    write_result_file,
)
from ..oracle.pipeline import DerivedParams, SearchConfig
from ..oracle.stats import base_thresholds
from ..oracle.toplist import finalize_candidates, update_toplist_from_maxima
from .errors import RADPUL_EFILE, RADPUL_EIO, RADPUL_EVAL, RadpulError


@dataclass
class DriverArgs:
    """The reference's command-line surface (``demod_binary.c:217-445``)
    that this slice honours, plus the batch size and the device."""

    inputfile: str
    outputfile: str
    templatebank: str
    zaplistfile: str | None = None
    f0: float = 250.0
    padding: float = 1.0
    fA: float = 0.04
    window: int = 1000
    white: bool = False
    batch_size: int = 16
    device: str = "cuda"


EXEC_NAME = "eah_brp_tpu_torch"


def _log(fmt: str, *args) -> None:
    sys.stderr.write(fmt % args)


def _search(args: DriverArgs) -> int:
    from ..models.search import (
        SearchGeometry,
        lut_step_for_bank,
        lut_tiles_for_bank,
        max_slope_for_bank,
        normalize_psi0,
        run_bank,
        state_to_natural,
    )
    from ..ops.whiten import whiten_and_zap

    if not args.white:
        raise RadpulError(
            RADPUL_EVAL,
            "Unwhitened searches are not supported by the PyTorch port yet: pass -W.",
        )
    if not args.zaplistfile:
        raise RadpulError(RADPUL_EFILE, "Whitening requires a zaplist file (-l).")
    dev = resolve_device(args.device)

    bank = read_template_bank(args.templatebank)
    bank = TemplateBank(bank.P, bank.tau, normalize_psi0(bank.psi0))
    wu = read_workunit(args.inputfile)
    cfg = SearchConfig(
        f0=args.f0, padding=args.padding, fA=args.fA, window=args.window, white=args.white
    )
    derived = DerivedParams.derive(wu.nsamples, float(wu.header["tsample"]), cfg)
    geom = SearchGeometry.from_derived(
        derived,
        max_slope=max_slope_for_bank(bank.P, bank.tau),
        lut_step=lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=lut_tiles_for_bank(bank.P, bank.psi0, derived.n_unpadded, derived.dt),
    )
    _log("Search on %s: %d templates, batch %d.\n", dev, len(bank), args.batch_size)

    ts = whiten_and_zap(wu.samples, derived, cfg, read_zaplist(args.zaplistfile), device=dev)
    M, T = run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=args.batch_size)

    cands = update_toplist_from_maxima(
        empty_candidates(),
        state_to_natural(M, geom),
        state_to_natural(T, geom),
        bank.P.astype(np.float32),
        bank.tau.astype(np.float32),
        bank.psi0.astype(np.float32),
        base_thresholds(cfg.fA, derived.fft_size),
        geom.window_2,
    )
    emitted = finalize_candidates(cands, derived.t_obs)
    write_result_file(
        args.outputfile,
        ResultFile(
            candidates=emitted,
            t_obs=derived.t_obs,
            header=ResultHeader(exec_name=EXEC_NAME),
        ),
    )
    _log("Data processing finished successfully!\n")
    return 0


def run_search(args: DriverArgs) -> int:
    """Returns 0 on success, a RADPUL_* error code otherwise."""
    try:
        return _search(args)
    except RadpulError as e:
        _log("%s\n", e)
        return e.code
    except (FileNotFoundError, EOFError) as e:
        _log("Couldn't open file: %s\n", e)
        return RADPUL_EIO
    except (TemplateBankError, ValueError) as e:
        _log("%s\n", e)
        return RADPUL_EVAL
