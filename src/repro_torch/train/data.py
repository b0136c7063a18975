"""Token data (the reference's ``train/data.py``): a synthetic stream and a
memmap-backed shard reader (fixed-length token files, sharding by
data-parallel rank, deterministic resume).

Both draw from numpy exactly as the reference does, so one seed gives the
same tokens in both packages; batches are int64 tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


@dataclasses.dataclass
class SyntheticTokens:
    """Deterministic synthetic token batches (model-free throughput tests).
    ``extras`` maps a further input's name to its shape after the batch
    axis (a VLM's ``image_embeds``, an encoder-decoder's ``audio_frames``):
    standard normal from the same numpy stream, in bfloat16."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    device: str | torch.device = "cpu"
    extras: dict | None = None

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            toks = rng.integers(0, self.vocab,
                                (self.batch, self.seq + 1), dtype=np.int32)
            out = {"tokens": _on(toks[:, :-1], self.device),
                   "labels": _on(toks[:, 1:], self.device)}
            for k, shape in (self.extras or {}).items():
                a = rng.standard_normal((self.batch, *shape), dtype=np.float32)
                out[k] = torch.from_numpy(a).to(self.device, torch.bfloat16)
            yield out


class MemmapTokens:
    """Reads token shards written as flat .bin int32 files, sharded by
    (rank, world), resumable from a step cursor."""

    def __init__(self, path: str | pathlib.Path, batch: int, seq: int,
                 rank: int = 0, world: int = 1, start_step: int = 0,
                 device: str | torch.device = "cpu"):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq = batch, seq
        self.rank, self.world = rank, world
        self.step = start_step
        self.device = device
        self.tokens_per_step = batch * (seq + 1) * world

    def __iter__(self):
        return self

    def __next__(self):
        need = self.batch * (self.seq + 1)
        base = (self.step * self.tokens_per_step + self.rank * need)
        base = base % max(len(self.tokens) - need, 1)
        chunk = np.asarray(self.tokens[base:base + need]).reshape(
            self.batch, self.seq + 1)
        self.step += 1
        return {"tokens": _on(chunk[:, :-1], self.device),
                "labels": _on(chunk[:, 1:], self.device)}

    @staticmethod
    def write_corpus(path, n_tokens: int, vocab: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, vocab, n_tokens, dtype=np.int32)
        arr.tofile(path)
        return path
