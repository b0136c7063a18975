"""Modeled-vs-measured validation loop of the port.

One contract, two halves: :mod:`.cases` pairs each smoke serving
scenario's analytical workload with its certified executable twin;
:mod:`.measure` runs the twin (the dry-run op count of :mod:`.opcount` and
steady-state wall clock, on the card unless asked for the CPU);
:mod:`.report` compares the two under declared error bands and persists
``BENCH_validation_torch.json`` for the ``tools/check_validation_torch.py``
gate. The cases/report halves are numpy-only.
"""
from .cases import (CASE_NAMES, ValidationCase, build_case, host_system,
                    predict_case, validation_cases)
from .measure import (HostCalibration, calibrate_host, card_refusal,
                      measure_cases, measure_dryrun, measure_wallclock,
                      trimmed_mean, validation_repeats, validation_warmup)
from .report import (REPORT_PATH, build_case_report, bytes_factor,
                     check_case, check_report, hybrid_step_time, load_report,
                     validation_band, wall_band, write_report)

__all__ = [
    "CASE_NAMES", "ValidationCase", "build_case", "host_system",
    "predict_case", "validation_cases",
    "HostCalibration", "calibrate_host", "card_refusal", "measure_cases",
    "measure_dryrun", "measure_wallclock", "trimmed_mean", "validation_repeats",
    "validation_warmup",
    "REPORT_PATH", "build_case_report", "bytes_factor", "check_case",
    "check_report", "hybrid_step_time", "load_report", "validation_band",
    "wall_band", "write_report",
]
