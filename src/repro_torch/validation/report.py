"""Predicted-vs-measured report: ratios, declared bands, and the gate (the
reference's ``validation/report.py``, with its environment knobs turned
into keyword arguments that keep its defaults).

The report is a dict-of-dicts persisted as ``BENCH_validation_torch.json``
(the reference's ``BENCH_validation.json`` is its own and never written
here); the gate (``tools/check_validation_torch.py``) re-derives
predictions and applies :func:`check_report`. Band semantics, per channel:

* **dry-run flops** — symmetric relative band (default ±25 %,
  ``band=``). The analytical graph and the counted decode step count the
  same matmuls; disagreement here is a modeling bug.
* **dry-run bytes** — asymmetric ratio band ``[1 - band, byte_factor]``.
  The prediction is an idealized floor (each byte moved once); the eager
  step reads and writes every intermediate of every operation, converts
  the bf16 cache to f32 for the plain attention and copies whole cache
  slices in place, so measured bytes sit well above the floor — but
  bounded, and never meaningfully *below* it.
* **dry-run collectives** — exact: a one-device step must move zero link
  bytes, and any collective in it is a sharding bug.
* **wall-clock compute term** — one-sided for every case: the analytical
  compute time (the device priced at its *measured* matmul rate) must not
  exceed measured TPOT × band — a lower-bound sanity check that survives
  launch-dominated tiny twins.
* **wall-clock hybrid fidelity** — two-sided (``wband=``), applied only to
  cases flagged ``wall_gate`` (the serving twin): the hybrid roofline —
  counted flops/bytes priced at calibrated rates,
  ``max(flops/flop_rate, bytes/mem_bw)`` — must land within wband× of
  measured TPOT on both sides. This is the paper's modeled-vs-measured
  claim (§X: predictions average 1.25× of measured).
"""
from __future__ import annotations

import json
import pathlib

DEFAULT_BAND = 0.25
DEFAULT_BYTES_FACTOR = 24.0
DEFAULT_WALL_BAND = 2.5

REPORT_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BENCH_validation_torch.json"


def _in_range(name: str, val: float, lo: float, hi: float) -> float:
    val = float(val)
    if not (lo <= val <= hi):
        raise ValueError(f"{name} must lie in [{lo}, {hi}], got {val}")
    return val


def validation_band(band: float = DEFAULT_BAND) -> float:
    """Symmetric relative band for dry-run FLOPs (and the floor of the bytes
    band), checked to lie in [0, 10]."""
    return _in_range("band", band, 0.0, 10.0)


def bytes_factor(factor: float = DEFAULT_BYTES_FACTOR) -> float:
    """Upper edge of the asymmetric bytes ratio band (measured/predicted),
    checked to lie in [1, 1e4]."""
    return _in_range("byte_factor", factor, 1.0, 1e4)


def wall_band(band: float = DEFAULT_WALL_BAND) -> float:
    """Two-sided multiplicative band for the hybrid-roofline wall-clock
    check on ``wall_gate`` cases, checked to lie in [1, 100]."""
    return _in_range("wband", band, 1.0, 100.0)


def hybrid_step_time(dry: dict, flop_rate: float, mem_bw: float) -> float:
    """Hybrid roofline: *counted* flops/bytes priced at *calibrated* rates.
    Isolates the pricing model from the byte-count gap."""
    return max(dry["flops"] / flop_rate, dry["bytes"] / mem_bw)


def build_case_report(name: str, predicted: dict, dry: dict,
                      wall: dict | None, calibration: dict | None,
                      wall_gate: bool) -> dict:
    """Assemble one case's row: raw numbers plus every gated ratio."""
    row = {
        "case": name,
        "wall_gate": wall_gate,
        "predicted": predicted,
        "dryrun": dry,
        "ratios": {
            "flops": dry["flops"] / predicted["flops"],
            "bytes": dry["bytes"] / predicted["bytes"],
        },
        "collective_delta_bytes": abs(
            dry["collective_bytes"] - predicted["collective_bytes"]),
    }
    if wall is not None and calibration is not None:
        hybrid = hybrid_step_time(dry, calibration["flop_rate"],
                                  calibration["mem_bw"])
        row["wallclock"] = wall
        row["calibration"] = calibration
        row["ratios"]["compute_term"] = predicted["t_compute"] / wall["tpot"]
        row["ratios"]["step_time"] = predicted["step_time"] / wall["tpot"]
        row["ratios"]["hybrid"] = hybrid / wall["tpot"]
        row["hybrid_step_time"] = hybrid
    return row


def check_case(row: dict, band: float = DEFAULT_BAND,
               byte_factor: float = DEFAULT_BYTES_FACTOR,
               wband: float = DEFAULT_WALL_BAND) -> list[str]:
    """Apply the declared bands to one case row; return violations
    (empty list == pass). Wall-clock checks only run if the row has a
    wall-clock section — absence is the caller's skip, not a failure."""
    band = validation_band(band)
    byte_factor = bytes_factor(byte_factor)
    wband = wall_band(wband)
    name = row["case"]
    out: list[str] = []

    r_flops = row["ratios"]["flops"]
    if abs(r_flops - 1.0) > band:
        out.append(f"{name}: dry-run flops ratio {r_flops:.4f} outside "
                   f"1±{band}")
    r_bytes = row["ratios"]["bytes"]
    if not (1.0 - band <= r_bytes <= byte_factor):
        out.append(f"{name}: dry-run bytes ratio {r_bytes:.4f} outside "
                   f"[{1.0 - band}, {byte_factor}]")
    if row["collective_delta_bytes"] != 0.0:
        out.append(f"{name}: one-device step moved "
                   f"{row['collective_delta_bytes']:.0f} collective link "
                   f"bytes (expected exactly 0)")

    if "wallclock" in row:
        r_comp = row["ratios"]["compute_term"]
        if r_comp > wband:
            out.append(f"{name}: predicted compute term is {r_comp:.3f}× "
                       f"measured TPOT — a lower bound exceeding measured "
                       f"by more than {wband}× means the compute model is "
                       f"broken, not the machine slow")
        if row["wall_gate"]:
            r_hyb = row["ratios"]["hybrid"]
            if not (1.0 / wband <= r_hyb <= wband):
                out.append(f"{name}: hybrid-roofline step time is "
                           f"{r_hyb:.3f}× measured TPOT, outside "
                           f"[1/{wband}, {wband}]")
    return out


def check_report(report: dict, band: float = DEFAULT_BAND,
                 byte_factor: float = DEFAULT_BYTES_FACTOR,
                 wband: float = DEFAULT_WALL_BAND) -> list[str]:
    """Gate a full report dict; returns all violations across cases."""
    out: list[str] = []
    for row in report["cases"]:
        out.extend(check_case(row, band=band, byte_factor=byte_factor,
                              wband=wband))
    return out


def write_report(report: dict, path: pathlib.Path | str = REPORT_PATH
                 ) -> pathlib.Path:
    path = pathlib.Path(path)
    path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return path


def load_report(path: pathlib.Path | str = REPORT_PATH) -> dict:
    return json.loads(pathlib.Path(path).read_text())
