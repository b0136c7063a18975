"""DSE-as-a-service: a long-lived sweep daemon over a warm DSEEngine
(the port's copy of the reference daemon; it prices on the CUDA card
unless given ``device="cpu"``).

The paper's pitch — interactive "what system should I build for this
workload" queries — only pays off when many clients can ask overlapping
what-if questions against a *warm* engine instead of cold-starting a
sweep each time. This package turns every prior engine layer into that
multi-tenant surface:

* :class:`~repro_torch.service.server.DSEService` — the daemon. Owns ONE
  :class:`~repro_torch.core.dse_engine.DSEEngine` in warm-session mode
  (process pool + cross-process memo store created once, reused by
  every request) and serves concurrent clients over an AF_UNIX socket
  with the same length-prefixed-pickle framing as the shared-store
  server (:mod:`repro_torch.core.memo_store`).
* :class:`~repro_torch.service.scheduler.Scheduler` — multiplexes concurrent
  queries: overlapping cells across clients are priced exactly once
  (shared result memo + per-round dedup), clients are interleaved
  round-robin with a per-round cell quota, and per-client budgets bound
  how many fresh solves any one client can cause.
* :class:`~repro_torch.service.client.DSEClient` — streaming consumer: rows
  arrive grid-index-tagged as plan groups finish, so a live Pareto
  frontier or an early-stop answer is available before the sweep ends.
* :mod:`~repro_torch.service.protocol` — the wire protocol: requests carry a
  scenario name (plus optional :class:`~repro_torch.search.DenseGridSpec`
  overrides or an explicit cell subset) and a mode — ``sweep``
  (exhaustive), ``search`` (budgeted policy by name), or ``reprice``
  (whole-grid chunked re-pricing).

Every row a client sees has already passed the house certify-or-die
checks inside the engine's streaming path — the daemon never relaxes
the bit-identity contract.

    from repro_torch.service import DSEService, DSEClient

    with DSEService(max_workers=4, shared_cache=True, device="cpu") as svc:
        with DSEClient(svc.path) as cli:
            reply = cli.sweep(scenario="llm", smoke=True)
            print(reply.summary["winner"])
"""
from .client import DSEClient, ServiceError, SweepReply
from .protocol import (MODES, PROTOCOL_VERSION, Query, RequestError,
                       parse_query, resolve_query)
from .scheduler import Scheduler, Ticket
from .server import DSEService

__all__ = [
    "DSEClient",
    "DSEService",
    "MODES",
    "PROTOCOL_VERSION",
    "Query",
    "RequestError",
    "Scheduler",
    "ServiceError",
    "SweepReply",
    "Ticket",
    "parse_query",
    "resolve_query",
]
