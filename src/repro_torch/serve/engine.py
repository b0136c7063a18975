"""Batched serving engine of the port: prefill, then decode with a cache
(K/V for attention layers, state and conv tail for SSM layers).

Mirrors ``repro/serve/engine.py``: TTFT is the prefill latency up to the
first sampled token, TPOT the decode step latency. Two decode loops share
one decode step:

* :meth:`ServeEngine.generate` — the serving path: the card runs ahead of
  the host through the decode loop; the host waits for it once after the
  first token (TTFT) and once after the last;
* :meth:`ServeEngine.decode_steady` — the measurement path: warm-up steps
  are discarded, then every steady-state step is synchronised and timed.

The reference compiles its decode step once (``jax.jit``); the port
captures it once in a CUDA graph. The engine owns one cache per batch size
at ``max_len`` positions, with static token and position buffers, and
prefill writes the prompt into that cache in place. On the card the first
decode step of a batch size runs eagerly (the warm-up, which also builds
the kernels), then ``decode_step`` is captured in a
:class:`~repro_torch.kernels._build.CountedGraph` that reads the cache,
the token and the position by address, and every later step writes the
token and position into their buffers and replays the graph, across
``generate`` calls too: a warm call captures nothing. The position lives on
the device, so the replayed step writes its K/V at the new position and
attends over ``pos + 1`` keys. Sampling stays outside the graph. A capture
that fails raises; the engine never falls back to eager decoding on the
card. On the CPU, which the caller asks for explicitly, the same step runs
eagerly, as it does on the card where a mesh axis of more than one rank
communicates over gloo (ranks sharing a card). The kernels' launch
counters count the graph's replays (``kernels.launches()``).

Prefill writes the first S positions of the cache, which leaves the same
contents as the reference's copy of the prefill cache into a serving-length
one, without the copy; positions from S on keep what they held, and decode
writes each before it reads it. The SSM state and conv tail do not depend
on ``max_len`` and are overwritten by prefill.

A request may bring a memory (B, M, d) for the cross-attention layers: a
VLM's image embeddings, or an encoder-decoder's encoder output
(``models.encode``), as the reference's engine takes it. Prefill attends to
it directly. The decode step reads it from the slot's static memory buffer,
in the compute dtype, into which :meth:`ServeEngine._decode` copies the
request's memory before each step: a replay of the captured step then sees
the new memory, and a warm call with another memory captures nothing. A
slot with memory is keyed by (batch size, memory shape), one without by
the batch size, so a step captured without memory never serves a request
that has one.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..device import resolve_device, synchronize
from ..kernels._build import CountedGraph
from ..models import decode_step, prefill
from ..models.config import ModelConfig
from ..models.transformer import _local_rows_cache, compute_dtype, gather_vocab
from ..parallel import dist as pd
from ..parallel.logical import current_mesh, current_rules


@dataclasses.dataclass
class GenerationResult:
    tokens: list
    ttft: float
    tpot: float
    tokens_per_s: float


@dataclasses.dataclass
class SteadyTiming:
    """Steady-state decode timings: ``step_times`` are post-warmup decode
    steps, each synchronised before its clock is read."""

    ttft: float                  # prefill + first sampled token, synced
    warmup: int                  # discarded decode steps before timing
    step_times: list[float]      # seconds per timed steady-state step
    batch: int                   # request slots served per step

    @property
    def tpot(self) -> float:
        """Mean steady-state time-per-output-token (seconds)."""
        return sum(self.step_times) / max(len(self.step_times), 1)

    @property
    def tokens_per_s(self) -> float:
        t = self.tpot
        return self.batch / t if t > 0 else 0.0


class _Slot:
    """One batch size's (and memory shape's) decode state: the cache at
    ``max_len`` positions, the token, position and memory the step reads,
    and on the card the captured step with its logits buffer."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, device,
                 memory_shape: tuple | None = None):
        self.cache = _local_rows_cache(cfg, batch, max_len, device)
        self.token = torch.zeros(batch, dtype=torch.int64, device=device)
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)
        self.memory = (None if memory_shape is None else torch.zeros(
            memory_shape, dtype=compute_dtype(cfg), device=device))
        self.graph: CountedGraph | None = None
        self.logits: torch.Tensor | None = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 8,
                 max_len: int = 1024, device=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        # Under installed rules and a mesh (``launch/mesh.py``), created and
        # called inside ``use_rules``: the prompts are the global batch, of
        # which each rank serves its rows of the data axes where they divide
        # it (else every rank serves all of it); the cache holds a multiple
        # of the model axis' positions; the logits are gathered over the
        # vocabulary to sample and split rows' tokens over the data axes to
        # return. The decode step is captured where every collective it
        # issues can be: those of a group of one rank (none), and NCCL's.
        # Over a gloo group of more ranks every step runs eagerly: gloo
        # stages a CUDA tensor through the host, which a capture cannot.
        self.mesh = current_mesh() if current_rules() is not None else None
        if self.mesh is not None:
            m = self.mesh.size("model")
            self.max_len = -(-max_len // m) * m
        self._capturable = self.device.type == "cuda" and (
            self.mesh is None or all(
                self.mesh.size(ax) == 1 or pd.backend(self.mesh.group(ax)) == "nccl"
                for ax in self.mesh.axis_names))
        self._slots: dict[int, _Slot] = {}
        self.captures = 0            # decode steps captured into a CUDA graph
        self.capture_s = 0.0         # host seconds spent capturing them

    def close(self) -> None:
        """Release every slot: its cache and its captured decode graph. A
        graph that holds NCCL collectives must be gone before the process
        group is destroyed (``torch.distributed.destroy_process_group``
        waits on a communicator that a live graph still uses); the engine
        captures again at its next step."""
        self._slots.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- shared plumbing ----------------------------------------------------
    def _check_window(self, b: int, s: int, n_tokens: int) -> None:
        if b > self.max_batch:
            raise ValueError(
                f"batch of {b} requests > max_batch {self.max_batch}; "
                f"re-create the engine with max_batch >= {b}")
        if s + n_tokens > self.max_len:
            raise ValueError(
                f"decode window overflows the KV cache: prompt length {s} "
                f"+ {n_tokens} new tokens > max_len {self.max_len}; "
                f"re-create the engine with max_len >= {s + n_tokens}")

    def _data_axes(self):
        if self.mesh is None:
            return None
        return ("pod", "data") if "pod" in self.mesh.axis_names else "data"

    def _rows_split(self, b: int) -> bool:
        """Whether the ranks of the data axes each serve their block of a
        batch of ``b`` rows (where there are several and they divide it)."""
        ax = self._data_axes()
        n = 1 if ax is None else self.mesh.size(ax)
        return n > 1 and b % n == 0

    def _local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (all of it where the batch is
        not split)."""
        if not self._rows_split(x.shape[0]):
            return x
        ax = self._data_axes()
        blk = x.shape[0] // self.mesh.size(ax)
        return x[self.mesh.index(ax) * blk:(self.mesh.index(ax) + 1) * blk]

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a rank's block of rows (gathered over the
        data axes)."""
        return pd.all_gather(x, 0, self.mesh.group(self._data_axes()))

    def _sample(self, logits: torch.Tensor, temperature: float,
                rng: torch.Generator | None) -> torch.Tensor:
        """Greedy argmax, or one categorical draw per row from ``rng``;
        every call draws a fresh variate, so positions differ."""
        logits = gather_vocab(self.cfg, logits)
        if temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    def _prefill(self, prompts: torch.Tensor,
                 memory: torch.Tensor | None = None):
        """Prefill into the cache of the batch size (and memory shape, the
        memory on the engine's device); returns (logits, slot)."""
        b = prompts.shape[0]
        shape = None if memory is None else tuple(memory.shape)
        key = b if shape is None else (b, shape)
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(self.cfg, b, self.max_len,
                                            self.device, shape)
        logits, _ = prefill(self.cfg, self.params, prompts.to(self.device),
                            cache=slot.cache, memory=memory)
        return logits, slot

    def _decode(self, slot: _Slot, token: torch.Tensor, pos: int,
                memory: torch.Tensor | None = None) -> torch.Tensor:
        """One decode step at position ``pos`` after ``token``, attending to
        ``memory`` (copied into the slot's buffer; a slot made for a memory
        needs one, and one made without takes none): the logits (B, V), on
        the card the graph's buffer, valid until the next step."""
        if (memory is None) != (slot.memory is None):
            raise ValueError("ServeEngine: a decode step's memory must match "
                             "its slot's (prefill with the same memory)")
        slot.token.copy_(token)
        slot.pos.fill_(pos)
        if memory is not None:
            slot.memory.copy_(memory)
        if not self._capturable:
            return decode_step(self.cfg, self.params, slot.cache, slot.token,
                               slot.pos, slot.memory)[0]
        if slot.graph is None:
            return self._warm_up_and_capture(slot)
        slot.graph.replay()
        return slot.logits

    def _warm_up_and_capture(self, slot: _Slot) -> torch.Tensor:
        """Run the step once eagerly on a side stream (it builds the kernels
        and allocates what a first call allocates), then capture it; returns
        the eager step's logits. A failed capture raises."""
        def step():
            return decode_step(self.cfg, self.params, slot.cache, slot.token,
                               slot.pos, slot.memory)[0]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            logits = step()
        current.wait_stream(side)
        graph = CountedGraph()
        t0 = time.perf_counter()
        try:
            # thread-local: a CUDA call of another thread (NCCL's watchdog
            # polling the events of earlier collectives) leaves the capture
            # valid; this thread's own host reads still fail it
            with graph.capture(capture_error_mode="thread_local"):
                slot.logits = step()
        except RuntimeError as e:    # torch raises CUDA errors as RuntimeErrors
            raise RuntimeError(
                f"ServeEngine: capturing the decode step of {self.cfg.name} at "
                f"batch {slot.token.shape[0]} in a CUDA graph failed; the "
                f"engine does not decode eagerly where it can capture") from e
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        slot.graph = graph
        return logits

    # --- serving path -------------------------------------------------------
    def generate(self, prompts: torch.Tensor, n_tokens: int,
                 memory: torch.Tensor | None = None, temperature: float = 0.0,
                 rng: torch.Generator | None = None) -> GenerationResult:
        """prompts: (B, S) int (same length; pad upstream); memory: (B, M,
        d) for the cross-attention layers, or None. ``rng`` must live on
        the engine's device."""
        b, s = prompts.shape
        self._check_window(b, s, n_tokens)
        split = self._rows_split(b)
        prompts = self._local_rows(prompts)
        if memory is not None:
            memory = self._local_rows(memory.to(self.device))
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, slot = self._prefill(prompts, memory)
            next_tok = self._sample(logits[:, -1], temperature, rng)
            synchronize(self.device)
            ttft = time.perf_counter() - t0

            toks = [next_tok]
            t1 = time.perf_counter()
            for i in range(n_tokens - 1):
                logits_i = self._decode(slot, toks[-1], s + i, memory)
                toks.append(self._sample(logits_i, temperature, rng))
            synchronize(self.device)
            dt = time.perf_counter() - t1
            if split:
                toks = [self._all_rows(t) for t in toks]
        tpot = dt / max(n_tokens - 1, 1)
        return GenerationResult(
            tokens=[t.tolist() for t in toks], ttft=ttft, tpot=tpot,
            tokens_per_s=b * n_tokens / (ttft + dt))

    # --- measurement path ---------------------------------------------------
    def decode_steady(self, prompts: torch.Tensor, n_steps: int = 16,
                      warmup: int = 2,
                      memory: torch.Tensor | None = None) -> SteadyTiming:
        """Steady-state greedy decode with per-step timing: prefill,
        ``warmup`` untimed decode steps (on a new batch size the first one
        also captures the step), then ``n_steps`` steps each synchronised
        and timed on its own. ``memory`` as for :meth:`generate`."""
        b, s = prompts.shape
        self._check_window(b, s, warmup + n_steps + 1)
        prompts = self._local_rows(prompts)
        if memory is not None:
            memory = self._local_rows(memory.to(self.device))
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, slot = self._prefill(prompts, memory)
            tok = self._sample(logits[:, -1], 0.0, None)
            synchronize(self.device)
            ttft = time.perf_counter() - t0

            pos = s
            for _ in range(warmup):
                tok = self._sample(self._decode(slot, tok, pos, memory), 0.0,
                                   None)
                pos += 1
            synchronize(self.device)

            times: list[float] = []
            for _ in range(n_steps):
                t1 = time.perf_counter()
                tok = self._sample(self._decode(slot, tok, pos, memory), 0.0,
                                   None)
                synchronize(self.device)
                times.append(time.perf_counter() - t1)
                pos += 1
        return SteadyTiming(ttft=ttft, warmup=warmup, step_times=times,
                            batch=b)
