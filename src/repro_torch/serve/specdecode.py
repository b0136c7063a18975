"""Sequence speculative decoding (Leviathan et al.; the paper's §VIII.B),
the reference's ``serve/specdecode.py``.

A draft model proposes K tokens autoregressively; the target model scores
the whole window in one forward pass; tokens are accepted while they match
the target's greedy choice (the greedy form of accepting with probability
min(1, p_target / p_draft)). The analytical twin (expected tokens per step
against K and the acceptance rate) lives in ``core/serving.py``.
"""
from __future__ import annotations

import torch

from ..models import forward
from ..models.config import ModelConfig


def speculative_generate(target_cfg: ModelConfig, target_params,
                         draft_cfg: ModelConfig, draft_params,
                         prompt: torch.Tensor, n_tokens: int, window: int = 4):
    """Greedy sequence speculative decoding, KV-less as the reference's:
    both models re-run ``forward`` over the growing sequence (an oracle for
    the acceptance logic at small-model scale), each on its own params'
    device, which ``prompt`` shares.

    prompt: (1, S) int. Returns (tokens list, acceptance_rate,
    n_target_calls)."""
    seq = prompt.long()
    produced = accepted_total = proposed_total = target_calls = 0
    out: list[int] = []
    with torch.no_grad():
        while produced < n_tokens:
            k = min(window, n_tokens - produced)
            # the draft proposes k tokens greedily
            dseq, proposal = seq, []
            for _ in range(k):
                nxt = forward(draft_cfg, draft_params, dseq)[:, -1].argmax(-1)
                proposal.append(int(nxt[0]))
                dseq = torch.cat([dseq, nxt[:, None]], dim=1)
            # the target verifies in one pass over seq + proposal
            ver_in = torch.cat([seq, seq.new_tensor([proposal])], dim=1)
            tlogits = forward(target_cfg, target_params, ver_in)
            target_calls += 1
            s0 = seq.shape[1]
            greedy = tlogits[0, s0 - 1:].argmax(-1).tolist()   # k + 1 tokens
            n_acc = 0
            while n_acc < k and greedy[n_acc] == proposal[n_acc]:
                n_acc += 1
            # the target's own token at the first mismatch (or the window's end)
            new_toks = proposal[:n_acc] + [greedy[n_acc]]
            out.extend(new_toks)
            produced += len(new_toks)
            seq = torch.cat([seq, seq.new_tensor([new_toks])], dim=1)
            accepted_total += n_acc
            proposed_total += k
    return out[:n_tokens], accepted_total / max(proposed_total, 1), target_calls
