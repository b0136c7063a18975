"""The service scheduler: one engine thread, many concurrent queries.

Design constraints this encodes:

* The warm :class:`~repro_torch.core.dse_engine.DSEEngine` is not thread-safe
  across concurrent calls, so exactly ONE scheduler thread drives it;
  connection threads only enqueue tickets and drain per-ticket output
  queues. Parallelism comes from the engine's warm worker pool, not
  from concurrent engine calls.
* **Dedup**: priced cells land in a shared result memo keyed by
  ``(work_key, cell)`` (:meth:`repro_torch.service.protocol.Resolved.cell_key`)
  that outlives individual requests. Within a round, a cell wanted by
  several clients is *introduced* by one and delivered to all —
  overlapping grids are priced exactly once (``cells_priced`` counts
  engine prices, ``dedup_hits`` counts rows served without one).
* **Fairness**: each scheduling round visits active sweep tickets in a
  rotating order and lets each introduce at most ``batch_cells`` new
  cells, so a huge query cannot starve a small one.
* **Budgets**: a sweep ticket's ``budget`` bounds how many fresh prices
  it can *cause*; rows served from the memo or another client's
  concurrent work are free. Cells that nobody has budget for are
  skipped and reported in the ``done`` summary.
* **Certification**: rows are emitted straight from the engine's
  streaming path (:meth:`~repro_torch.core.dse_engine.DSEEngine.sweep_cells_iter`),
  which runs the house certify-or-die checks *before* yielding — the
  scheduler never emits an uncertified row. ``search`` queries run with
  ``certify=True`` (the exhaustive-oracle check) and ``reprice`` queries
  raise inside the engine on any winner mismatch.

``search`` and ``reprice`` queries run as atomic units between sweep
rounds (their engine calls are not interruptible); their priced
observations seed the same result memo, so a later sweep over the same
cells streams instantly.

The engine-level learned rank stage (``rank=``, see
:mod:`repro_torch.learned`) applies to every query the scheduler routes —
sweeps, searches and reprices all flow through the same plan → rank →
price pipeline — and because one engine serves all requests, its
:meth:`~repro_torch.core.dse_engine.DSEEngine._ranker_for_run` refit check
sees the memo harvest grow across *requests*: a warm daemon's ranker
improves as clients price new regions of the design space.
"""
from __future__ import annotations

import itertools
import queue
import threading

from .protocol import Query, Resolved, error_msg


class Ticket:
    """One admitted query: its output stream plus sweep bookkeeping."""

    _ids = itertools.count(1)

    def __init__(self, query: Query, resolved: Resolved):
        self.id = next(Ticket._ids)
        self.query = query
        self.resolved = resolved
        self.out: queue.SimpleQueue = queue.SimpleQueue()
        self._cancelled = threading.Event()
        self.failed = False
        # sweep bookkeeping (grid index -> (cell_key, cell))
        self.remaining: dict[int, tuple] = {}
        self.rows = 0
        self.dedup_hits = 0
        self.budget_used = 0
        self.skipped = 0
        self.best: tuple | None = None  # (infeasible, iter_time, index, point)

    # -- client-side stream control ------------------------------------------
    def cancel(self) -> None:
        """Client went away mid-stream: stop emitting; the scheduler
        drops the ticket at the next round. Cells it introduced that are
        already in flight still get priced (and serve other waiters)."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def emit(self, msg: dict) -> None:
        if not self.cancelled:
            self.out.put(msg)

    # -- row accounting ------------------------------------------------------
    def note_row(self, index: int, cell, point) -> None:
        self.rows += 1
        key = ((point is None or not point.plan.feasible),
               float("inf") if point is None else float(point.plan.iter_time),
               index, point)
        if self.best is None or key[:3] < self.best[:3]:
            self.best = key

    def budget_left(self) -> bool:
        return self.query.budget is None or self.budget_used < self.query.budget


_STOP = object()


class Scheduler:
    """Single-threaded multiplexer over one warm engine (see module
    docstring for the dedup / fairness / budget contract)."""

    def __init__(self, engine, batch_cells: int = 8):
        if batch_cells < 1:
            raise ValueError(f"batch_cells must be >= 1, got {batch_cells}")
        self.engine = engine
        self.batch_cells = batch_cells
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._results: dict[tuple, object] = {}   # cell_key -> point | None
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "rows_streamed": 0, "cells_priced": 0,
                       "dedup_hits": 0, "errors": 0, "memo_cells": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dse-service-scheduler")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Scheduler":
        self._thread.start()
        return self

    def close(self) -> None:
        self._inbox.put(_STOP)
        self._thread.join(timeout=60)

    def submit(self, ticket: Ticket) -> None:
        self._inbox.put(ticket)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["memo_cells"] = len(self._results)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    # -- main loop -----------------------------------------------------------
    def _run(self) -> None:
        active: list[Ticket] = []
        rotate = 0
        while True:
            # ingest: block when idle, drain opportunistically when busy
            if not active:
                item = self._inbox.get()
                if item is _STOP:
                    return
                self._admit(item, active)
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    return
                self._admit(item, active)
            if active:
                self._round(active, rotate)
                rotate += 1
                active = self._finish_pass(active)

    # -- admission -----------------------------------------------------------
    def _admit(self, t: Ticket, active: list[Ticket]) -> None:
        self._bump("requests")
        if t.query.mode == "search":
            self._run_search(t)
            return
        if t.query.mode == "reprice":
            self._run_reprice(t)
            return
        res = t.resolved
        for gidx in res.indices:
            cell = res.grid[gidx]
            key = res.cell_key(cell)
            if key in self._results:
                # a previous (or concurrent, earlier-admitted) request
                # already priced this cell — serve it from the memo
                point = self._results[key]
                t.emit({"kind": "row", "index": gidx, "cell": cell,
                        "point": point})
                t.note_row(gidx, cell, point)
                t.dedup_hits += 1
                self._bump("rows_streamed")
                self._bump("dedup_hits")
            else:
                t.remaining[gidx] = (key, cell)
        if t.remaining:
            active.append(t)
        else:
            t.emit({"kind": "done", "summary": self._summary(t)})

    # -- sweep rounds --------------------------------------------------------
    def _round(self, active: list[Ticket], rotate: int) -> None:
        live = [t for t in active if not t.cancelled and not t.failed]
        if not live:
            return
        start = rotate % len(live)
        order = live[start:] + live[:start]
        # fair interleaving: each ticket may introduce at most
        # batch_cells NEW cells per round; joining a cell another ticket
        # introduced (or one already priced) costs nothing
        introduced: dict[tuple, tuple] = {}   # key -> (resolved, cell, owner)
        for t in order:
            quota = self.batch_cells
            for gidx, (key, cell) in t.remaining.items():
                if quota == 0:
                    break
                if key in self._results or key in introduced:
                    continue
                if not t.budget_left():
                    break
                introduced[key] = (t.resolved, cell, t.id)
                t.budget_used += 1
                quota -= 1
        if not introduced:
            return
        # group by work semantics: one engine call per work_key batch
        by_work: dict[tuple, list[tuple]] = {}
        for key, (res, cell, owner) in introduced.items():
            by_work.setdefault(res.work_key, []).append((key, cell, res,
                                                        owner))
        for work_key, entries in by_work.items():
            res = entries[0][2]
            cells = [cell for _key, cell, _res, _owner in entries]
            try:
                for item in self.engine.sweep_cells_iter(res.work_fn, cells,
                                                         res.spec):
                    key, _cell, _res, owner = entries[item.index]
                    self._results[key] = item.point
                    self._bump("cells_priced")
                    self._deliver(active, key, owner)
            except Exception as exc:  # engine failure must not kill the daemon
                self._bump("errors")
                for t in active:
                    if (not t.cancelled and not t.failed
                            and t.resolved.work_key == work_key):
                        t.failed = True
                        t.emit(error_msg("engine-error",
                                         f"sweep failed: {exc!r}"))

    def _deliver(self, active: list[Ticket], key: tuple, owner: int) -> None:
        point = self._results[key]
        for t in active:
            if t.cancelled or t.failed:
                continue
            hits = [gidx for gidx, (k, _c) in t.remaining.items() if k == key]
            for gidx in hits:
                _key, cell = t.remaining.pop(gidx)
                t.emit({"kind": "row", "index": gidx, "cell": cell,
                        "point": point})
                t.note_row(gidx, cell, point)
                self._bump("rows_streamed")
                if t.id != owner:
                    # a shared solve: this client got the row without
                    # paying for the price — the cross-client dedup hit
                    t.dedup_hits += 1
                    self._bump("dedup_hits")

    def _finish_pass(self, active: list[Ticket]) -> list[Ticket]:
        still: list[Ticket] = []
        for t in active:
            if t.cancelled or t.failed:
                continue
            if not t.budget_left() and t.remaining:
                # out of budget: keep only cells some OTHER live ticket
                # can still pay for (we will be served by its dedup)
                for gidx, (key, _cell) in list(t.remaining.items()):
                    sharable = any(
                        key in (k for k, _c in u.remaining.values())
                        and u.budget_left()
                        for u in active
                        if u is not t and not u.cancelled and not u.failed)
                    if not sharable:
                        del t.remaining[gidx]
                        t.skipped += 1
            if t.remaining:
                still.append(t)
            else:
                t.emit({"kind": "done", "summary": self._summary(t)})
        return still

    def _summary(self, t: Ticket) -> dict:
        winner = None
        if t.best is not None:
            infeasible, iter_time, index, point = t.best
            winner = {"index": index,
                      "cell": t.resolved.grid[index],
                      "feasible": not infeasible,
                      "iter_time": iter_time,
                      "row": None if point is None else point.row()}
        return {"mode": t.query.mode, "rows": t.rows,
                "dedup_hits": t.dedup_hits, "budget_used": t.budget_used,
                "skipped": t.skipped, "winner": winner}

    # -- search / reprice queries (atomic between sweep rounds) --------------
    def _run_search(self, t: Ticket) -> None:
        from ..search.policy import make_policy

        res = t.resolved
        budget = t.query.budget or len(res.grid)
        try:
            policy = make_policy(t.query.policy, seed=t.query.seed,
                                 batch_size=t.query.batch_size)
            result = self.engine.search(
                res.work_fn, res.spec, policy=policy, budget=budget,
                certify=True,
                progress=lambda rec: t.emit({"kind": "progress", **rec}))
        except Exception as exc:
            self._bump("errors")
            t.emit(error_msg("search-failed", f"{exc!r}"))
            return
        # harvest: search observations went through the same certified
        # plan->price path as a sweep, so they seed the shared memo and
        # later sweeps over these cells stream for free
        for obs in result.evaluated.values():
            key = res.cell_key(res.grid[obs.index])
            if key not in self._results:
                self._results[key] = obs.point
        if result.best_index >= 0:
            cell = res.grid[result.best_index]
            t.emit({"kind": "row", "index": result.best_index, "cell": cell,
                    "point": result.best_point})
            t.note_row(result.best_index, cell, result.best_point)
            self._bump("rows_streamed")
        t.emit({"kind": "done", "summary": {
            "mode": "search", "policy": result.policy,
            "budget": result.budget, "evals_used": result.evals_used,
            "cheap_evals": result.cheap_evals,
            "certified": result.certified,
            "oracle_index": result.oracle_index,
            "best_index": result.best_index,
            "seconds": result.seconds,
            "winner": self._summary(t)["winner"]}})

    def _run_reprice(self, t: Ticket) -> None:
        res = t.resolved
        try:
            report = self.engine.reprice_grid(res.work_fn, res.spec)
        except Exception as exc:
            self._bump("errors")
            t.emit(error_msg("reprice-failed", f"{exc!r}"))
            return
        t.emit({"kind": "done", "summary": {"mode": "reprice", **report}})
