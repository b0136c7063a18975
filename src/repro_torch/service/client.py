"""Streaming client for the DSE service daemon.

One :class:`DSEClient` is one connection — concurrent queries need one
client each (which is exactly how the dedup/fairness machinery is meant
to be exercised). Rows stream back as the warm engine's plan groups
finish, so consumers can render a live Pareto frontier or stop early by
simply closing the client; the daemon cancels the ticket and keeps the
shared work for everyone else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import socket
import time
from typing import Iterator

from ..core.dse import DesignPoint, GridCell
from ..core.dse_engine import pareto_frontier
from ..core.memo_store import recv_msg, send_msg


class ServiceError(RuntimeError):
    """A structured error reply from the daemon (``code`` + message)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


@dataclasses.dataclass
class SweepReply:
    """A collected query result: grid-index-tagged rows + done summary."""

    indices: list[int]
    cells: list[GridCell]
    points: list[DesignPoint | None]
    summary: dict
    progress: list[dict]

    def live_points(self) -> list[DesignPoint]:
        """The priced points in grid order — for a full-grid sweep this
        list is bit-identical to a direct ``DSEEngine.sweep``."""
        order = sorted(range(len(self.indices)),
                       key=lambda k: self.indices[k])
        return [self.points[k] for k in order if self.points[k] is not None]

    def rows(self) -> list[dict]:
        return [p.row() for p in self.live_points()]

    def frontier(self) -> list[DesignPoint]:
        return pareto_frontier(self.live_points())

    @property
    def winner(self) -> dict | None:
        return self.summary.get("winner")


class DSEClient:
    """Blocking client over the service's unix socket."""

    def __init__(self, path: str, connect_timeout: float = 20.0):
        self.path = path
        deadline = time.monotonic() + connect_timeout
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        while True:
            try:
                self._sock.connect(path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() >= deadline:
                    self._sock.close()
                    raise
                time.sleep(0.05)

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.close()

    def __enter__(self) -> "DSEClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- control ops ---------------------------------------------------------
    def _roundtrip(self, msg: dict) -> dict:
        send_msg(self._sock, msg)
        reply = recv_msg(self._sock)
        if reply is None:
            raise ConnectionError("service closed the connection")
        if reply.get("kind") == "error":
            raise ServiceError(reply.get("code", "error"),
                               reply.get("message", ""))
        return reply

    def ping(self) -> dict:
        return self._roundtrip({"op": "ping"})

    def stats(self) -> dict:
        return self._roundtrip({"op": "stats"})

    def shutdown_server(self) -> None:
        self._roundtrip({"op": "shutdown"})

    # -- queries -------------------------------------------------------------
    def query_iter(self, **fields) -> Iterator[dict]:
        """Send one query, yield its stream (rows / progress), return on
        the terminal ``done`` (also yielded). A structured error reply
        raises :class:`ServiceError`; the connection stays usable."""
        send_msg(self._sock, {"op": "query", **fields})
        while True:
            msg = recv_msg(self._sock)
            if msg is None:
                raise ConnectionError("service closed mid-stream")
            kind = msg.get("kind")
            if kind == "error":
                raise ServiceError(msg.get("code", "error"),
                                   msg.get("message", ""))
            yield msg
            if kind == "done":
                return

    def _collect(self, **fields) -> SweepReply:
        indices: list[int] = []
        cells: list[GridCell] = []
        points: list[DesignPoint | None] = []
        progress: list[dict] = []
        summary: dict = {}
        for msg in self.query_iter(**fields):
            kind = msg["kind"]
            if kind == "row":
                indices.append(msg["index"])
                cells.append(msg["cell"])
                points.append(msg["point"])
            elif kind == "progress":
                progress.append(msg)
            elif kind == "done":
                summary = msg["summary"]
        return SweepReply(indices=indices, cells=cells, points=points,
                          summary=summary, progress=progress)

    def sweep(self, scenario: str = "llm", smoke: bool = True,
              **fields) -> SweepReply:
        """Exhaustive (or ``cells=``-restricted, ``budget=``-bounded)
        sweep; rows collected, winner in ``reply.summary['winner']``."""
        return self._collect(mode="sweep", scenario=scenario, smoke=smoke,
                             **fields)

    def search(self, scenario: str = "llm", smoke: bool = True,
               policy: str = "halving", budget: int | None = None,
               **fields) -> SweepReply:
        """Budgeted policy search; the certified winner is the single
        streamed row, per-round progress in ``reply.progress``."""
        return self._collect(mode="search", scenario=scenario, smoke=smoke,
                             policy=policy, budget=budget, **fields)

    def reprice(self, scenario: str = "llm", smoke: bool = True,
                **fields) -> dict:
        """Whole-grid chunk-streamed re-pricing; returns the engine's
        report dict (``winners_identical`` is certify-or-die)."""
        return self._collect(mode="reprice", scenario=scenario, smoke=smoke,
                             **fields).summary
