"""The DSE service daemon.

Lifecycle follows the shared-store server in
:mod:`repro_torch.core.memo_store`: an AF_UNIX listener polling a stop flag,
one thread per client connection, a structured reply for every request
that parses, and a client crash killing only its own connection thread.
The crucial ordering detail: :meth:`DSEService.start` warms the engine
(forks/spawns every pool worker) **before** any service thread exists —
forking a multithreaded process later is the documented deadlock hazard
the engine's transport auto-pick exists to avoid.

Run standalone::

    PYTHONPATH=src python -m repro_torch.service --socket PATH [--device cpu]

or in-process (tests, examples)::

    with DSEService(max_workers=4, shared_cache=True) as svc:
        ...  # DSEClient(svc.path)

The engine prices on the CUDA card unless given ``device="cpu"``
(``--device cpu``): with a non-numpy pricing backend and no device, a
daemon without a card raises at :meth:`DSEService.start`.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import socket
import tempfile
import threading
import time

from ..core.dse_engine import DSEEngine
from ..core.memo_store import diff_stats, recv_msg, send_msg
from .protocol import (PROTOCOL_VERSION, RequestError, error_msg, parse_query,
                       resolve_query)
from .scheduler import Scheduler, Ticket


class DSEService:
    """Long-lived DSE sweep daemon over one warm engine.

    Parameters
    ----------
    socket_path:
        Where to listen. Default: a fresh temp directory (removed on
        close). The path is available as :attr:`path` once started.
    engine:
        An existing :class:`~repro_torch.core.dse_engine.DSEEngine` to serve
        with (it will be switched into warm-session mode; the caller
        keeps ownership and teardown stays with the caller). Default:
        the service builds its own from ``engine_kwargs`` and tears it
        down on close.
    batch_cells:
        Scheduler fairness quota — max *new* cells one client may
        introduce per scheduling round.
    """

    def __init__(self, socket_path: str | None = None,
                 engine: DSEEngine | None = None, *,
                 batch_cells: int = 8, **engine_kwargs):
        self._owns_engine = engine is None
        self.engine = engine or DSEEngine(**engine_kwargs)
        self.batch_cells = batch_cells
        self._tmpdir: str | None = None
        if socket_path is None:
            # AF_UNIX paths are limited to ~108 bytes: keep the directory
            # name short
            self._tmpdir = tempfile.mkdtemp(prefix="dfm-dse-")
            socket_path = os.path.join(self._tmpdir, "dse.sock")
        self.path = socket_path
        self.scheduler: Scheduler | None = None
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._started = False
        self._t0 = 0.0
        self._store_stats0: dict | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DSEService":
        if self._started:
            return self
        if self.engine._resolved_backend() != "numpy":
            # the engine prices on a device: without one, fail now, not
            # at the first request
            from ..device import resolve_device

            resolve_device(self.engine.device)
        # warm the engine FIRST: all pool workers must exist before this
        # process grows accept/scheduler threads (fork safety)
        self.engine.start()
        store = self.engine._session_store
        if store is not None:
            with contextlib.suppress(Exception):
                self._store_stats0 = store.stats()
        self.scheduler = Scheduler(self.engine,
                                   batch_cells=self.batch_cells).start()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(self.path)
            srv.listen(64)
            srv.settimeout(0.1)  # poll the stop flag between accepts
        except OSError:
            srv.close()
            self.scheduler.close()
            if self._owns_engine:
                self.engine.shutdown()
            raise
        self._srv = srv
        self._t0 = time.monotonic()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dse-service-accept")
        self._accept_thread.start()
        self._started = True
        return self

    def close(self) -> None:
        """Stop accepting, drain the scheduler, tear down what we own."""
        if not self._started:
            return
        self._started = False
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10)
        if self._srv is not None:
            with contextlib.suppress(OSError):
                self._srv.close()
        with contextlib.suppress(OSError):
            os.unlink(self.path)
        if self.scheduler is not None:
            self.scheduler.close()
        if self._owns_engine:
            self.engine.shutdown()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __enter__(self) -> "DSEService":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        """Block until a client's ``shutdown`` request (or timeout)."""
        return self._stop.wait(timeout)

    # -- connection handling -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        """One client connection: requests in, streams out.

        A malformed request gets a structured error reply and the
        connection stays usable; an unframeable/garbage message (or a
        dead client socket) closes only this connection — the daemon,
        the warm pool and every other client keep running.
        """
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn)
                except (pickle.UnpicklingError, EOFError, AttributeError,
                        ImportError, IndexError, ValueError) as exc:
                    # undecodable frame: reply (best effort), drop client
                    with contextlib.suppress(OSError):
                        send_msg(conn, error_msg(
                            "bad-frame", f"undecodable request: {exc!r}"))
                    return
                if msg is None:
                    return  # client closed cleanly
                op = msg.get("op") if isinstance(msg, dict) else None
                if op == "ping":
                    send_msg(conn, {"kind": "pong",
                                    "protocol": PROTOCOL_VERSION})
                elif op == "stats":
                    send_msg(conn, self._stats())
                elif op == "shutdown":
                    send_msg(conn, {"kind": "bye"})
                    self._stop.set()
                    return
                elif op == "query":
                    if not self._query(conn, msg):
                        return
                else:
                    send_msg(conn, error_msg(
                        "bad-op", f"unknown op {op!r}; expected one of "
                                  f"query/ping/stats/shutdown"))
        except OSError:
            return  # client died mid-message; daemon stays up
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _query(self, conn: socket.socket, msg: dict) -> bool:
        """Run one query exchange; False if the connection is dead."""
        try:
            query = parse_query(msg)
            ticket = Ticket(query, resolve_query(query))
        except RequestError as exc:
            send_msg(conn, error_msg(exc.code, str(exc)))
            return True  # the *connection* is fine; daemon keeps serving
        self.scheduler.submit(ticket)
        try:
            while True:
                out = ticket.out.get()
                send_msg(conn, out)
                if out.get("kind") in ("done", "error"):
                    return True
        except OSError:
            # client disconnected mid-stream: stop emitting for this
            # ticket; in-flight cells still price and stay in the shared
            # memo for everyone else — the warm pool is untouched
            ticket.cancel()
            return False

    def _stats(self) -> dict:
        store = self.engine._session_store
        store_stats = None
        if store is not None:
            with contextlib.suppress(Exception):
                store_stats = store.stats()
        return {
            "kind": "stats",
            "protocol": PROTOCOL_VERSION,
            "uptime_s": time.monotonic() - self._t0,
            "scheduler": self.scheduler.stats(),
            "engine": {"max_workers": self.engine.max_workers,
                       "session_active": self.engine.session_active,
                       "warm_pool": self.engine._session_pool is not None,
                       "pricing_backend": self.engine.pricing_backend,
                       "device": (None if self.engine.device is None
                                  else str(self.engine.device)),
                       "prune": self.engine.prune,
                       "rank": self.engine.rank,
                       "rank_model": self.engine._ranker is not None,
                       "shared_cache": self.engine.shared_cache},
            "shared_store": store_stats,
            "shared_store_delta": diff_stats(self._store_stats0, store_stats),
        }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="DFModel DSE service daemon")
    ap.add_argument("--socket", default=None,
                    help="unix socket path (default: fresh temp dir)")
    ap.add_argument("--workers", type=int, default=None,
                    help="engine pool size (default: cpu count)")
    ap.add_argument("--shared-cache", action="store_true",
                    help="share one cross-process memo store across requests")
    ap.add_argument("--backend", default="auto",
                    help="pricing backend (numpy/torch/kernel/kernel-f32; "
                         "auto is kernel)")
    ap.add_argument("--device", default=None,
                    help="where a non-numpy backend prices (default: the "
                         "CUDA card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--prune", default="auto", help="candidate pruning policy")
    ap.add_argument("--rank", default="auto",
                    help="learned rank-stage policy (on/off/auto; "
                         "auto is off)")
    ap.add_argument("--rank-model", default=None, metavar="PATH",
                    help="persist/load the trained ranker at PATH so warm "
                         "sessions survive daemon restarts")
    ap.add_argument("--batch-cells", type=int, default=8,
                    help="scheduler fairness quota per client per round")
    args = ap.parse_args(argv)
    svc = DSEService(socket_path=args.socket,
                     batch_cells=args.batch_cells,
                     max_workers=args.workers,
                     shared_cache=args.shared_cache,
                     pricing_backend=args.backend,
                     prune=args.prune,
                     rank=args.rank,
                     rank_model_path=args.rank_model,
                     device=args.device)
    with svc:
        print(f"dse-service: serving on {svc.path}", flush=True)
        try:
            svc.wait()
        except KeyboardInterrupt:
            pass
    print("dse-service: stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
