"""Serving launcher of the port: one device, batched generation.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \\
      --prompt-len 2048 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
      --requests 8 --prompt-len 2048 --tokens 32

:func:`run_serve` is the importable body; ``main`` is the argparse shell.
It runs on the CUDA card unless ``device`` (``--device``) says otherwise.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..serve.engine import GenerationResult, ServeEngine


def run_serve(cfg: ModelConfig, requests: int = 4, prompt_len: int = 16,
              tokens: int = 16, seed: int = 0,
              device=None) -> GenerationResult:
    """Initialise params, serve one batched greedy generation, return its
    timings. Deterministic in ``seed`` (params from ``seed``, prompts from
    ``seed + 1``)."""
    device = resolve_device(device)
    params = init_params(cfg, seed=seed, device=device)
    engine = ServeEngine(cfg, params, max_batch=requests,
                         max_len=prompt_len + tokens + 1, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len),
                            generator=gen, device=device)
    res = engine.generate(prompts, n_tokens=tokens)
    print(f"{cfg.name} on {device}")
    print(f"TTFT {res.ttft * 1e3:.1f} ms  TPOT {res.tpot * 1e3:.2f} ms "
          f" throughput {res.tokens_per_s:.1f} tok/s")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mistral_nemo_12b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", help="default: the CUDA card")
    args = ap.parse_args()
    run_serve(get_config(args.arch, smoke=args.smoke),
              requests=args.requests, prompt_len=args.prompt_len,
              tokens=args.tokens, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
