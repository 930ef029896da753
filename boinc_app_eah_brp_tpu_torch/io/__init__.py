"""Workunit, template-bank, zaplist and candidate-file formats.

Copies of the reference package's jax-free ``io`` modules, so the port
reads and writes the same files without importing that package."""

import numpy as np

from .formats import CP_CAND_DTYPE, DD_HEADER_DTYPE, N_CAND, N_CAND_5
from .results import (
    ResultFile,
    ResultHeader,
    format_candidate_line,
    parse_result_file,
    write_result_file,
)
from .templates import TemplateBank, TemplateBankError, read_template_bank, write_template_bank
from .workunit import Workunit, read_workunit, write_workunit
from .zaplist import read_zaplist, zap_bin_ranges


def empty_candidates() -> np.ndarray:
    """Zeroed 500-entry candidate array: the reference's calloc'd initial
    toplist (``demod_binary.c:490``)."""
    return np.zeros(N_CAND, dtype=CP_CAND_DTYPE)


__all__ = [
    "CP_CAND_DTYPE",
    "DD_HEADER_DTYPE",
    "N_CAND",
    "N_CAND_5",
    "ResultFile",
    "ResultHeader",
    "TemplateBank",
    "TemplateBankError",
    "Workunit",
    "empty_candidates",
    "format_candidate_line",
    "parse_result_file",
    "read_template_bank",
    "read_workunit",
    "read_zaplist",
    "write_result_file",
    "write_template_bank",
    "write_workunit",
    "zap_bin_ranges",
]
