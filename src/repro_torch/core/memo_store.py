"""Cross-process shared memo store for DSE sweeps.

The §VI.C sweep re-solves identical subproblems at almost every design
point, and :mod:`repro_torch.core.memo` already memoises them *per process* —
but pool workers of a parallel :class:`~repro_torch.core.dse_engine.DSEEngine`
sweep fork with a cold (or frozen) cache and cannot reuse each other's
solves.  This module adds the missing shared tier: a store that every
worker of one sweep reads and writes, layered *under* the local memo dict
(write-through, local-first) so call sites never change.

Two backends, selected per pool transport by
``DSEEngine(shared_cache=...)``:

``MmapStore``
    A lock-striped hash table in a plain mmap'd file.  Each stripe is an
    append-only log of pickled ``(key, value)`` entries guarded by an
    ``fcntl`` byte-range lock, so any process that can open the file path
    can share it — fork and forkserver workers attach by path via the
    pool initializer.  Readers take the stripe lock shared, writers
    exclusive; a racing writer of an already-present key discards its
    value (first writer wins), which keeps entries exactly-once.

``ServerStore``
    A tiny unix-domain-socket server owned by a daemon child process —
    the portable (spawn-safe) fallback.  Clients speak a batched
    length-prefixed pickle protocol: pending puts are buffered and
    piggybacked onto the next get, so the common miss→solve→put→next-get
    cycle costs one round trip.  The server survives client crashes
    (one thread per connection) and tears down on a ``shutdown`` message
    or when its owner exits (daemonized).

Both present the same client surface — ``get``/``put``/``flush``/
``stats``/``close`` plus a picklable :class:`StoreHandle` that workers
``connect()`` — and both aggregate per-space hit/miss/insert counters in
the shared medium itself, so the parent reads one cross-process total
after the pool drains (``DSEEngine.last_shared_stats``).

Keys arrive as opaque bytes (the memo layer pickles its structural
``(space, key)`` tuples).  Pickle bytes for structurally-equal keys built
independently in two processes are identical in practice for the frozen
dataclass / tuple / float keys the memo uses; any divergence merely costs
a cache miss, never a wrong value.  Every store error degrades the same
way — the memo layer treats a failing shared tier as a miss.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import mmap
import multiprocessing
import os
import pickle
import shutil
import socket
import struct
import tempfile
import threading
import time
from typing import Any

try:  # byte-range locks for the mmap backend; absent on Windows
    import fcntl
except ImportError:  # pragma: no cover - exercised only off-Linux
    fcntl = None  # type: ignore[assignment]

PICKLE_PROTO = pickle.HIGHEST_PROTOCOL

_MAGIC = b"DFMEMO01"
_U64 = struct.Struct("<Q")
_STRIPE_HDR = struct.Struct("<QQ")      # used bytes (past header), entries
_ENTRY_HDR = struct.Struct("<II")       # key length, value length
_SLOT_NAME = 48                          # max space-name bytes per stats slot
_SLOT = struct.Struct(f"<{_SLOT_NAME}sQQQQ")  # name, hits, misses, ins, drop
_N_SLOTS = 16


def _empty_stats(backend: str) -> dict:
    return {"backend": backend, "hits": 0, "misses": 0, "inserts": 0,
            "dropped": 0, "entries": 0, "by_space": {}}


def _merge_space(stats: dict, space: str, hits: int, misses: int,
                 inserts: int, dropped: int) -> None:
    stats["by_space"][space] = {"hits": hits, "misses": misses,
                                "inserts": inserts, "dropped": dropped}
    stats["hits"] += hits
    stats["misses"] += misses
    stats["inserts"] += inserts
    stats["dropped"] += dropped


@dataclasses.dataclass(frozen=True)
class StoreHandle:
    """Picklable pointer to a live shared store.

    Shipped to pool workers (via the executor initializer) so each worker
    opens its own connection — fork children must not reuse the parent's
    socket or lock-owning file descriptor.
    """

    kind: str  # "mmap" | "server"
    path: str

    def connect(self):
        if self.kind == "mmap":
            return MmapStore(path=self.path, create=False)
        if self.kind == "server":
            # short connect timeout: the owner proved the server up before
            # shipping handles, so a refused connect here means it died —
            # degrade to misses quickly instead of stalling the worker
            return ServerClient(self.path, connect_timeout=2.0)
        raise ValueError(f"unknown store kind {self.kind!r}")


# --------------------------- mmap backend ------------------------------------
class MmapStore:
    """Lock-striped shared hash table in an mmap'd file.

    Layout: ``magic | n_stripes | stripe_bytes`` header, a stats region of
    ``_N_SLOTS`` fixed per-space counter slots, then ``n_stripes`` stripes
    of ``stripe_bytes`` each.  A stripe is ``(used, count)`` followed by an
    append-only log of ``(klen, vlen, key, value)`` entries.  Keys hash to
    a stripe with BLAKE2b (deterministic across processes, unlike
    ``hash()``); lookups scan the stripe under a shared ``fcntl`` range
    lock, inserts re-scan under the exclusive lock so racing writers of
    one key keep a single entry.  A full stripe drops further inserts —
    dropping is always safe for a memo cache and is counted in stats.
    """

    backend = "mmap"

    def __init__(self, path: str | None = None, n_stripes: int = 64,
                 stripe_bytes: int = 1 << 20, create: bool | None = None):
        if fcntl is None:
            raise RuntimeError("MmapStore needs fcntl byte-range locks "
                               "(unavailable on this platform)")
        if create is None:
            create = path is None
        self._owner = create
        if path is None:
            fd, path = tempfile.mkstemp(prefix="dfmodel-memo-",
                                        suffix=".mmap")
            os.close(fd)
        self.path = path
        if create:
            self._format(path, n_stripes, stripe_bytes)
        self._open()

    # -- file plumbing --
    def _format(self, path: str, n_stripes: int, stripe_bytes: int) -> None:
        head = _MAGIC + _U64.pack(n_stripes) + _U64.pack(stripe_bytes)
        stats_len = _N_SLOTS * _SLOT.size
        total = len(head) + stats_len + n_stripes * stripe_bytes
        with open(path, "wb") as f:
            f.write(head)
            f.truncate(total)  # sparse: pages materialize only when used

    def _open(self) -> None:
        self._fd = os.open(self.path, os.O_RDWR)
        head = os.pread(self._fd, len(_MAGIC) + 16, 0)
        if head[:len(_MAGIC)] != _MAGIC:
            os.close(self._fd)
            raise ValueError(f"{self.path} is not a DFModel memo store")
        self.n_stripes = _U64.unpack_from(head, len(_MAGIC))[0]
        self.stripe_bytes = _U64.unpack_from(head, len(_MAGIC) + 8)[0]
        self._stats_off = len(_MAGIC) + 16
        self._data_off = self._stats_off + _N_SLOTS * _SLOT.size
        size = self._data_off + self.n_stripes * self.stripe_bytes
        self._mm = mmap.mmap(self._fd, size)
        self._pid = os.getpid()
        # per-space [hits, misses, inserts, dropped] deltas not yet folded
        # into the shared stats region (one fcntl lock per op is the
        # dominant overhead otherwise)
        self._pending: dict[str, list[int]] = {}
        self._pending_ops = 0

    def _ensure_process(self) -> None:
        # A fork child inheriting this object must not reuse the parent's
        # fd: fcntl locks are per (process, inode) but closing ANY fd to
        # the file drops the process's locks, and lock state would be
        # confusing at best. Reopen on first use in a new process.
        if self._pid != os.getpid():
            with contextlib.suppress(OSError, ValueError):
                self._mm.close()
            with contextlib.suppress(OSError):
                os.close(self._fd)
            self._open()

    @contextlib.contextmanager
    def _locked(self, start: int, length: int, exclusive: bool):
        op = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
        fcntl.lockf(self._fd, op, length, start)
        try:
            yield
        finally:
            fcntl.lockf(self._fd, fcntl.LOCK_UN, length, start)

    def _stripe_of(self, key: bytes) -> int:
        digest = hashlib.blake2b(key, digest_size=8).digest()
        return _U64.unpack(digest)[0] % self.n_stripes

    def _scan(self, off: int, used: int, key: bytes) -> bytes | None:
        pos, end = off + _STRIPE_HDR.size, off + _STRIPE_HDR.size + used
        mm = self._mm
        while pos < end:
            klen, vlen = _ENTRY_HDR.unpack_from(mm, pos)
            pos += _ENTRY_HDR.size
            if klen == len(key) and mm[pos:pos + klen] == key:
                return bytes(mm[pos + klen:pos + klen + vlen])
            pos += klen + vlen
        return None

    # -- client surface --
    def get(self, space: str, key: bytes) -> bytes | None:
        self._ensure_process()
        off = self._data_off + self._stripe_of(key) * self.stripe_bytes
        with self._locked(off, self.stripe_bytes, exclusive=False):
            used, _ = _STRIPE_HDR.unpack_from(self._mm, off)
            value = self._scan(off, used, key)
        self._bump(space, hits=value is not None, misses=value is None)
        return value

    def put(self, space: str, key: bytes, value: bytes) -> None:
        self._ensure_process()
        need = _ENTRY_HDR.size + len(key) + len(value)
        capacity = self.stripe_bytes - _STRIPE_HDR.size
        if need > capacity:
            self._bump(space, dropped=True)
            return
        off = self._data_off + self._stripe_of(key) * self.stripe_bytes
        with self._locked(off, self.stripe_bytes, exclusive=True):
            used, count = _STRIPE_HDR.unpack_from(self._mm, off)
            if self._scan(off, used, key) is not None:
                return  # racing writer already inserted: first one wins
            if used + need > capacity:
                self._bump(space, dropped=True)
                return
            pos = off + _STRIPE_HDR.size + used
            _ENTRY_HDR.pack_into(self._mm, pos, len(key), len(value))
            pos += _ENTRY_HDR.size
            self._mm[pos:pos + len(key)] = key
            self._mm[pos + len(key):pos + len(key) + len(value)] = value
            _STRIPE_HDR.pack_into(self._mm, off, used + need, count + 1)
        self._bump(space, inserts=True)

    def flush(self) -> None:
        """Fold pending stats deltas into the shared region (entries are
        never buffered — the data stripes are always current)."""
        self._flush_stats()

    def items(self) -> list[tuple[bytes, bytes]]:
        """Every stored ``(key, value)`` entry, stripe by stripe.

        The harvest surface for surrogate training
        (:meth:`repro_torch.core.memo.SolveCache.harvest`): one shared lock per
        stripe, so concurrent writers are never blocked for long and each
        stripe snapshot is internally consistent (entries are append-only,
        a later put only grows the log past the ``used`` mark we read).
        Stats counters do not move — harvesting is observational.
        """
        self._ensure_process()
        out: list[tuple[bytes, bytes]] = []
        for stripe in range(self.n_stripes):
            off = self._data_off + stripe * self.stripe_bytes
            with self._locked(off, self.stripe_bytes, exclusive=False):
                used, _ = _STRIPE_HDR.unpack_from(self._mm, off)
                pos = off + _STRIPE_HDR.size
                end = pos + used
                mm = self._mm
                while pos < end:
                    klen, vlen = _ENTRY_HDR.unpack_from(mm, pos)
                    pos += _ENTRY_HDR.size
                    out.append((bytes(mm[pos:pos + klen]),
                                bytes(mm[pos + klen:pos + klen + vlen])))
                    pos += klen + vlen
        return out

    # -- shared stats --
    def _bump(self, space: str, hits: bool = False, misses: bool = False,
              inserts: bool = False, dropped: bool = False) -> None:
        delta = self._pending.setdefault(space, [0, 0, 0, 0])
        delta[0] += hits
        delta[1] += misses
        delta[2] += inserts
        delta[3] += dropped
        self._pending_ops += 1
        if self._pending_ops >= 64:
            self._flush_stats()

    def _flush_stats(self) -> None:
        pending, self._pending = self._pending, {}
        self._pending_ops = 0
        if not any(any(d) for d in pending.values()):
            return
        region = _N_SLOTS * _SLOT.size
        with self._locked(self._stats_off, region, exclusive=True):
            for space, (dh, dm, di, dd) in pending.items():
                name = space.encode()[:_SLOT_NAME - 1]
                for slot in range(_N_SLOTS):
                    pos = self._stats_off + slot * _SLOT.size
                    raw, h, m, i, d = _SLOT.unpack_from(self._mm, pos)
                    cur = raw.rstrip(b"\0")
                    if cur and cur != name:
                        continue
                    _SLOT.pack_into(self._mm, pos, name, h + dh, m + dm,
                                    i + di, d + dd)
                    break
                # (no break: all slots taken by other spaces — this
                # space's stats are lost; the store itself still works)

    def stats(self) -> dict:
        self._ensure_process()
        self._flush_stats()
        out = _empty_stats(self.backend)
        region = _N_SLOTS * _SLOT.size
        with self._locked(self._stats_off, region, exclusive=False):
            for slot in range(_N_SLOTS):
                pos = self._stats_off + slot * _SLOT.size
                raw, h, m, i, d = _SLOT.unpack_from(self._mm, pos)
                name = raw.rstrip(b"\0")
                if name:
                    _merge_space(out, name.decode(), h, m, i, d)
        out["entries"] = out["inserts"]  # the shared tier never evicts
        return out

    # -- lifecycle --
    def handle(self) -> StoreHandle:
        return StoreHandle("mmap", self.path)

    def close(self) -> None:
        with contextlib.suppress(OSError, ValueError):
            self._flush_stats()
        with contextlib.suppress(OSError, ValueError):
            self._mm.close()
        with contextlib.suppress(OSError):
            os.close(self._fd)
        if self._owner and self._pid == os.getpid():
            with contextlib.suppress(OSError):
                os.unlink(self.path)


def diff_stats(before: dict | None, after: dict | None) -> dict | None:
    """Per-request delta between two :meth:`stats` snapshots of one
    long-lived store (the DSE service daemon keeps a single store across
    requests — :mod:`repro_torch.service` reports each request's share of the
    cross-process reuse with this). Counter keys subtract; ``entries``
    reports the *new* entries; ``by_space`` carries per-space deltas for
    the spaces that moved."""
    if after is None:
        return None
    if before is None:
        return after
    out = _empty_stats(after.get("backend", "?"))
    for key in ("hits", "misses", "inserts", "dropped"):
        out[key] = after.get(key, 0) - before.get(key, 0)
    out["entries"] = after.get("entries", 0) - before.get("entries", 0)
    spaces = set(after.get("by_space", {})) | set(before.get("by_space", {}))
    for space in sorted(spaces):
        a = after.get("by_space", {}).get(space, {})
        b = before.get("by_space", {}).get(space, {})
        delta = {k: a.get(k, 0) - b.get(k, 0)
                 for k in ("hits", "misses", "inserts", "dropped")}
        if any(delta.values()):
            out["by_space"][space] = delta
    return out


# --------------------------- server backend ----------------------------------
def send_msg(sock: socket.socket, obj: Any) -> None:
    """One length-prefixed pickled message (the wire framing shared by
    the store server and the DSE service daemon, :mod:`repro_torch.service`)."""
    payload = pickle.dumps(obj, PICKLE_PROTO)
    sock.sendall(_U64.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Any | None:
    """One length-prefixed message; ``None`` on a cleanly closed peer."""
    head = b""
    while len(head) < _U64.size:
        chunk = sock.recv(_U64.size - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _U64.unpack(head)
    parts, got = [], 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return pickle.loads(b"".join(parts))


def serve(path: str) -> None:
    """Store-server main loop (runs in the daemon child process).

    One thread per client connection; a client crash (EOF / reset on its
    socket) kills only that thread.  The loop exits on a ``shutdown``
    message and removes its socket file.
    """
    data: dict[bytes, bytes] = {}
    counters: dict[str, list[int]] = {}  # space -> [hits, misses, ins, drop]
    lock = threading.Lock()
    stop = threading.Event()

    def bump(space: str) -> list[int]:
        return counters.setdefault(space, [0, 0, 0, 0])

    def handle(conn: socket.socket) -> None:
        try:
            while not stop.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    return
                op = msg[0]
                if op == "batch":
                    _, puts, gets = msg
                    with lock:
                        for space, key, value in puts:
                            if key not in data:  # racing writers: first wins
                                data[key] = value
                                bump(space)[2] += 1
                        values = []
                        for space, key in gets:
                            value = data.get(key)
                            bump(space)[0 if value is not None else 1] += 1
                            values.append(value)
                    send_msg(conn, values)
                elif op == "items":
                    with lock:
                        snapshot = list(data.items())
                    send_msg(conn, snapshot)
                elif op == "stats":
                    with lock:
                        out = _empty_stats("server")
                        for space, (h, m, i, d) in sorted(counters.items()):
                            _merge_space(out, space, h, m, i, d)
                        out["entries"] = len(data)
                    send_msg(conn, out)
                elif op == "shutdown":
                    send_msg(conn, True)
                    stop.set()
                    return
                else:
                    send_msg(conn, None)
        except OSError:
            return  # client died mid-message; server stays up
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(128)
        srv.settimeout(0.1)  # poll the stop flag between accepts
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=handle, args=(conn,), daemon=True).start()
    finally:
        with contextlib.suppress(OSError):
            srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


class ServerClient:
    """Batching client for :func:`serve`.

    ``put`` buffers locally; the buffer rides along with the next ``get``
    (or a size-triggered / explicit ``flush``), so the memo layer's
    miss→solve→put→next-get cycle costs one round trip per lookup.  A dead
    server turns every operation into a cheap no-op miss — a sweep never
    fails because its cache fell over.
    """

    backend = "server"

    def __init__(self, path: str, flush_every: int = 8,
                 connect_timeout: float = 20.0, alive_check=None):
        self.path = path
        self.flush_every = flush_every
        self.connect_timeout = connect_timeout
        self._alive_check = alive_check  # fail fast on a dead server proc
        self._sock: socket.socket | None = None
        self._puts: list[tuple[str, bytes, bytes]] = []
        self._dead = False
        self._pid = os.getpid()

    def _connection(self) -> socket.socket:
        if self._pid != os.getpid():
            # fork child: the inherited socket belongs to the parent's
            # protocol stream; abandon it (close would not disturb the
            # parent, but reconnecting is the only safe option) and any
            # inherited put buffer (re-putting is harmless, first wins).
            self._sock, self._puts, self._dead = None, [], False
            self._pid = os.getpid()
        if self._sock is None:
            deadline = time.monotonic() + self.connect_timeout
            while True:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    sock.connect(self.path)
                    self._sock = sock
                    break
                except OSError:
                    sock.close()
                    if self._alive_check is not None \
                            and not self._alive_check():
                        raise OSError("memo server process is gone")
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.02)
        return self._sock

    def _rpc(self, msg: tuple) -> Any:
        try:
            sock = self._connection()
            send_msg(sock, msg)
            reply = recv_msg(sock)
            if reply is None:
                raise OSError("memo server closed the connection")
            return reply
        except OSError:
            self._dead = True
            if self._sock is not None:
                with contextlib.suppress(OSError):
                    self._sock.close()
                self._sock = None
            raise

    def get(self, space: str, key: bytes) -> bytes | None:
        if self._dead and self._pid == os.getpid():
            return None
        puts, self._puts = self._puts, []
        try:
            return self._rpc(("batch", puts, [(space, key)]))[0]
        except OSError:
            return None

    def put(self, space: str, key: bytes, value: bytes) -> None:
        if self._dead and self._pid == os.getpid():
            return
        self._puts.append((space, key, value))
        if len(self._puts) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._puts:
            return
        puts, self._puts = self._puts, []
        with contextlib.suppress(OSError):
            self._rpc(("batch", puts, []))

    def stats(self) -> dict:
        self.flush()
        return self._rpc(("stats",))

    def items(self) -> list[tuple[bytes, bytes]]:
        """Every stored ``(key, value)`` entry (harvest surface; a dead
        server yields the empty list, matching the degrade-to-miss
        contract of ``get``)."""
        if self._dead and self._pid == os.getpid():
            return []
        try:
            self.flush()
            return self._rpc(("items",)) or []
        except OSError:
            return []

    def shutdown_server(self) -> None:
        self.flush()
        self._rpc(("shutdown",))

    def handle(self) -> StoreHandle:
        return StoreHandle("server", self.path)

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self.flush()
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
            self._sock = None


class ServerStore:
    """Parent-side owner of a store-server process + its local client.

    Spawn-safe: the server is a daemon child started via an explicitly
    chosen multiprocessing context (default ``spawn``, matching the pools
    it serves — forking a parent that holds a CUDA context is the hazard
    the server backend exists to avoid), and workers connect by socket
    path.  The
    daemon flag guarantees teardown even if ``close()`` is never reached.
    """

    backend = "server"

    def __init__(self, mp_context: multiprocessing.context.BaseContext
                 | str | None = None):
        if not hasattr(socket, "AF_UNIX"):
            raise RuntimeError("ServerStore needs unix-domain sockets")
        if mp_context is None or isinstance(mp_context, str):
            mp_context = multiprocessing.get_context(mp_context or "spawn")
        # AF_UNIX paths are limited to ~108 bytes: keep the name short
        self._dir = tempfile.mkdtemp(prefix="dfm-memo-")
        self.path = os.path.join(self._dir, "memo.sock")
        self._proc = mp_context.Process(target=serve, args=(self.path,),
                                        daemon=True, name="dfmodel-memo-srv")
        self._proc.start()
        self._client = ServerClient(self.path,
                                    alive_check=self._proc.is_alive)
        # fail fast if the server never comes up (the first RPC retries
        # connect until connect_timeout or the server process dies) —
        # and never leak the daemon + temp dir when the probe gives up
        try:
            self._client.stats()
        except BaseException:
            self.close()
            raise

    def get(self, space: str, key: bytes) -> bytes | None:
        return self._client.get(space, key)

    def put(self, space: str, key: bytes, value: bytes) -> None:
        self._client.put(space, key, value)

    def flush(self) -> None:
        self._client.flush()

    def stats(self) -> dict:
        return self._client.stats()

    def items(self) -> list[tuple[bytes, bytes]]:
        return self._client.items()

    def handle(self) -> StoreHandle:
        return StoreHandle("server", self.path)

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self._client.shutdown_server()
        self._client.close()
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():  # pragma: no cover - shutdown always acks
            self._proc.terminate()
            self._proc.join(timeout=1.0)
        shutil.rmtree(self._dir, ignore_errors=True)


# ------------------------------ selection ------------------------------------
def choose_backend(start_method: str) -> str:
    """Backend for a pool transport: the mmap table for fork/forkserver
    (workers share the file by path with zero per-op IPC), the socket
    server as the portable fallback for spawn (and for platforms without
    ``fcntl`` range locks)."""
    if fcntl is not None and start_method in ("fork", "forkserver"):
        return "mmap"
    if hasattr(socket, "AF_UNIX"):
        return "server"
    if fcntl is not None:  # pragma: no cover - no-AF_UNIX platforms
        return "mmap"
    raise RuntimeError("no shared memo-store backend available "
                       "(need fcntl or AF_UNIX)")


def create_store(backend: str = "auto",
                 mp_context: multiprocessing.context.BaseContext | str |
                 None = None):
    """Build a parent-side shared store.

    ``backend="auto"`` picks per the pool's start method
    (:func:`choose_backend`); ``"mmap"`` / ``"server"`` force one.
    """
    if backend in ("auto", True):
        method = (mp_context if isinstance(mp_context, str)
                  else mp_context.get_start_method() if mp_context is not None
                  else multiprocessing.get_start_method(allow_none=False))
        backend = choose_backend(method)
    if backend == "mmap":
        return MmapStore()
    if backend == "server":
        return ServerStore(mp_context=mp_context)
    raise ValueError(f"unknown shared-cache backend {backend!r}; "
                     f"expected 'auto', 'mmap' or 'server'")
