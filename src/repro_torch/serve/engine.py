"""Batched serving engine of the port: prefill, then decode with a cache
(K/V for attention layers, state and conv tail for SSM layers).

Mirrors ``repro/serve/engine.py``: TTFT is the prefill latency up to the
first sampled token, TPOT the decode step latency. Two decode loops share
the model's ``decode_step``:

* :meth:`ServeEngine.generate` — the serving path: the card runs ahead of
  the host through the decode loop; the host waits for it once after the
  first token (TTFT) and once after the last;
* :meth:`ServeEngine.decode_steady` — the measurement path: warm-up steps
  are discarded, then every steady-state step is synchronised and timed.

The K/V cache holds ``max_len`` positions from the start and prefill writes
the first S, which leaves the same contents as the reference's copy of the
prefill cache into a serving-length one, without the copy; the SSM state
and conv tail do not depend on ``max_len`` and carry over as they are.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..device import resolve_device, synchronize
from ..models import decode_step, prefill
from ..models.config import ModelConfig


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


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 8,
                 max_len: int = 1024, device=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)

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

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                rng: torch.Generator | None) -> torch.Tensor:
        """Greedy argmax, or one categorical draw per row from ``rng``;
        every call draws a fresh variate, so positions differ."""
        if temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    def _prefill(self, prompts: torch.Tensor):
        return prefill(self.cfg, self.params, prompts.to(self.device),
                       max_len=self.max_len)

    # --- serving path -------------------------------------------------------
    def generate(self, prompts: torch.Tensor, n_tokens: int,
                 temperature: float = 0.0,
                 rng: torch.Generator | None = None) -> GenerationResult:
        """prompts: (B, S) int (same length; pad upstream). ``rng`` must
        live on the engine's device."""
        b, s = prompts.shape
        self._check_window(b, s, n_tokens)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = self._prefill(prompts)
            next_tok = self._sample(logits[:, -1], temperature, rng)
            synchronize(self.device)
            ttft = time.perf_counter() - t0

            toks = [next_tok]
            t1 = time.perf_counter()
            pos = s
            for _ in range(n_tokens - 1):
                logits_i, cache = decode_step(self.cfg, self.params, cache,
                                              toks[-1], pos)
                toks.append(self._sample(logits_i, temperature, rng))
                pos += 1
            synchronize(self.device)
            dt = time.perf_counter() - t1
        tpot = dt / max(n_tokens - 1, 1)
        return GenerationResult(
            tokens=[t.tolist() for t in toks], ttft=ttft, tpot=tpot,
            tokens_per_s=b * n_tokens / (ttft + dt))

    # --- measurement path ---------------------------------------------------
    def decode_steady(self, prompts: torch.Tensor, n_steps: int = 16,
                      warmup: int = 2) -> SteadyTiming:
        """Steady-state greedy decode with per-step timing: prefill,
        ``warmup`` untimed decode steps, then ``n_steps`` steps each
        synchronised and timed on its own."""
        b, s = prompts.shape
        self._check_window(b, s, warmup + n_steps + 1)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = self._prefill(prompts)
            tok = self._sample(logits[:, -1], 0.0, None)
            synchronize(self.device)
            ttft = time.perf_counter() - t0

            pos = s
            for _ in range(warmup):
                logits_i, cache = decode_step(self.cfg, self.params, cache,
                                              tok, pos)
                tok = self._sample(logits_i, 0.0, None)
                pos += 1
            synchronize(self.device)

            times: list[float] = []
            for _ in range(n_steps):
                t1 = time.perf_counter()
                logits_i, cache = decode_step(self.cfg, self.params, cache,
                                              tok, pos)
                tok = self._sample(logits_i, 0.0, None)
                synchronize(self.device)
                times.append(time.perf_counter() - t1)
                pos += 1
        return SteadyTiming(ttft=ttft, warmup=warmup, step_times=times,
                            batch=b)
