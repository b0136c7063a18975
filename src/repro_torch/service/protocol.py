"""Wire protocol of the DSE service.

Length-prefixed pickled dicts over an AF_UNIX stream socket — exactly
the framing :mod:`repro_torch.core.memo_store` uses between sweep workers and
the shared-store daemon (``send_msg`` / ``recv_msg`` are re-exported
from there, so both daemons ride one battle-tested transport).

A connection carries a sequence of request/reply exchanges. Control
ops (``ping`` / ``stats`` / ``shutdown``) get a single reply; a
``query`` op gets a *stream*:

    client -> server   {"op": "query", "mode": "sweep", ...}
    server -> client   zero or more {"kind": "row" | "progress"} messages
    server -> client   exactly one  {"kind": "done" | "error"} terminal

``row`` messages are grid-index-tagged (``index`` is the cell's index in
the request's resolved design grid) and carry the fully priced
:class:`~repro_torch.core.dse.DesignPoint` (``None`` for undecomposable
cells), so progressive consumers can maintain a live Pareto frontier or
stop early by closing the connection. Every row was certified inside
the engine's streaming path before it was emitted — the service never
weakens the certify-or-die rule.

Requests are plain data: scenarios and search policies travel by *name*
(resolved server-side from :mod:`repro_torch.workloads.scenarios` and
:func:`repro_torch.search.make_policy`), never as pickled callables.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..core.dse import GridCell
from ..core.dse_engine import SweepSpec
from ..core.memo_store import recv_msg, send_msg  # noqa: F401  (re-export)

PROTOCOL_VERSION = 1
MODES = ("sweep", "search", "reprice")


class RequestError(ValueError):
    """A malformed request. The daemon answers with a structured
    ``{"kind": "error", "code", "message"}`` reply and keeps serving."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def error_msg(code: str, message: str) -> dict:
    return {"kind": "error", "code": code, "message": message}


@dataclasses.dataclass(frozen=True)
class Query:
    """One validated query, still unresolved (names, not callables)."""

    mode: str = "sweep"
    scenario: str = "llm"
    smoke: bool = True
    #: optional explicit cell subset: indices into the resolved grid
    cells: tuple[int, ...] | None = None
    #: optional DenseGridSpec field overrides replacing the scenario grid
    dense: dict | None = None
    #: global-batch scale applied to the scenario workload (ScaledWorkFn)
    workload_scale: float = 1.0
    #: sweep mode: max cells this client may cause to be priced;
    #: search mode: full-evaluation budget (None → grid size)
    budget: int | None = None
    policy: str = "halving"
    seed: int = 0
    batch_size: int | None = None
    client: str = ""


_QUERY_FIELDS = {f.name for f in dataclasses.fields(Query)}


def parse_query(msg: dict) -> Query:
    """Validate a raw ``query`` message into a :class:`Query`."""
    if not isinstance(msg, dict):
        raise RequestError("bad-request", f"expected a dict, got "
                                          f"{type(msg).__name__}")
    fields = {k: v for k, v in msg.items() if k != "op"}
    unknown = set(fields) - _QUERY_FIELDS
    if unknown:
        raise RequestError("bad-field",
                           f"unknown query fields {sorted(unknown)}; "
                           f"known: {sorted(_QUERY_FIELDS)}")
    try:
        q = Query(**fields)
    except TypeError as exc:
        raise RequestError("bad-request", str(exc)) from exc
    if q.mode not in MODES:
        raise RequestError("bad-mode",
                           f"unknown mode {q.mode!r}; available: {MODES}")
    if not isinstance(q.scenario, str):
        raise RequestError("bad-scenario", "scenario must be a string name")
    if q.budget is not None and (not isinstance(q.budget, int)
                                 or q.budget < 1):
        raise RequestError("bad-budget",
                           f"budget must be a positive int, got {q.budget!r}")
    if q.cells is not None:
        try:
            cells = tuple(int(i) for i in q.cells)
        except (TypeError, ValueError) as exc:
            raise RequestError(
                "bad-cells", f"cells must be grid indices: {exc}") from exc
        if len(set(cells)) != len(cells):
            raise RequestError("bad-cells", "cells contains duplicates")
        q = dataclasses.replace(q, cells=cells)
    if q.dense is not None and not isinstance(q.dense, dict):
        raise RequestError("bad-dense",
                           "dense must be a dict of DenseGridSpec fields")
    try:
        scale = float(q.workload_scale)
    except (TypeError, ValueError) as exc:
        raise RequestError("bad-scale",
                           f"workload_scale must be a number: {exc}") from exc
    if scale <= 0:
        raise RequestError("bad-scale",
                           f"workload_scale must be > 0, got {scale}")
    return dataclasses.replace(q, workload_scale=scale)


@dataclasses.dataclass(frozen=True)
class Resolved:
    """A query bound to the callables/grids it named.

    ``work_key`` identifies the *work semantics* of a cell independently
    of which request asked for it — the scheduler's cross-client dedup
    key is ``(work_key, cell)``, so two clients sweeping overlapping
    grids (even different subsets, even via different DenseGridSpec
    overrides with the same sweep parameters) share one priced solve per
    cell.
    """

    work_fn: Callable
    spec: SweepSpec
    grid: tuple[GridCell, ...]
    #: the grid indices this query covers (the whole grid by default)
    indices: tuple[int, ...]
    work_key: tuple

    def cell_key(self, cell: GridCell) -> tuple:
        return (self.work_key, cell)


def resolve_query(q: Query) -> Resolved:
    """Bind a :class:`Query` to its scenario work_fn, sweep spec and
    grid. Name-resolution failures become :class:`RequestError`\\ s."""
    from ..workloads.scenarios import get_scenario

    try:
        sc = get_scenario(q.scenario, smoke=q.smoke)
    except KeyError as exc:
        raise RequestError("unknown-scenario", str(exc)) from exc
    work_fn, spec = sc.work_fn, sc.spec
    if q.dense is not None:
        from ..search.grid import DenseGridSpec

        try:
            spec = DenseGridSpec(**q.dense).spec()
        except (TypeError, ValueError) as exc:
            raise RequestError("bad-dense", str(exc)) from exc
    if q.workload_scale != 1.0:
        from ..search.grid import ScaledWorkFn

        work_fn = ScaledWorkFn(work_fn, q.workload_scale)
    grid = tuple(spec.grid())
    if q.cells is not None:
        bad = [i for i in q.cells if not 0 <= i < len(grid)]
        if bad:
            raise RequestError(
                "bad-cells", f"cell indices out of range (grid size "
                             f"{len(grid)}): {bad[:5]}")
        indices = q.cells
    else:
        indices = tuple(range(len(grid)))
    if q.mode == "search" and q.policy is not None:
        from ..search.policy import POLICY_NAMES

        if q.policy not in POLICY_NAMES:
            raise RequestError(
                "unknown-policy", f"unknown search policy {q.policy!r}; "
                                  f"available: {POLICY_NAMES}")
    work_key = (q.scenario, bool(q.smoke), q.workload_scale, spec.n_chips,
                spec.max_tp, spec.max_pp, spec.execution)
    return Resolved(work_fn=work_fn, spec=spec, grid=grid, indices=indices,
                    work_key=work_key)
