"""Speculative decoding: draft-sourced speculation, target-exact output.

The port of ``k8s_dra_driver_tpu/models/speculative.py``.  A draft
source proposes ``draft_len`` tokens, then the target scores all of
them in ONE ``forward_with_cache`` call (one stream of the big weights
instead of ``draft_len``); the accepted prefix plus one correction
token advance the output per iteration.  Two draft sources share the
verify loop:

- **draft model** (``speculative_generate``): a small model (anything
  from a distilled sibling to the target itself) proposes greedily,
  with its own parameters and KV cache;
- **prompt n-gram lookup** (``ngram_speculative_generate``): proposals
  are gathered from the request's own prompt at the last occurrence of
  the current token (``decode.ngram_propose_rows``).

Greedy speculation is exact: a draft token is accepted only when it
equals the target's own greedy choice, and the first divergence is
replaced by that choice, so under the same numerics the output equals
``greedy_generate`` on the target.  In bf16, and in f32 on the card,
the window forward and the one-token steps may sum in different orders,
so a near tie can pick a different, equally greedy continuation.
Batched rows advance in lockstep by the minimum acceptance across the
batch: rows that accepted more re-emit the same target-greedy tokens
in the next iteration.

Rollback is positional: the cache masks keys by position, so rejecting
speculative entries is not advancing ``pos``; stale rows are invisible
and the next write at the same offset replaces them.  The loop reads
the batch's acceptance back to the host once an iteration: that value
is the loop's own control (its trip count and the next offsets).

Both entry points take ``mesh=`` (``decode.forward_with_cache``'s):
the target's and the draft model's params are this rank's
``shard_params`` blocks under the same mesh, as the JAX package's
jitted loops run on ``shard_params`` weights, and their caches hold
this rank's ``H_kv/tp`` heads.  The logits are whole on every rank, so
the acceptance each rank reads back is the same and every rank runs
the same iterations.
"""

from __future__ import annotations

import dataclasses

import torch

from .decode import (KVCache, _device, forward_with_cache, init_cache,
                     ngram_propose_rows)
from .transformer import Params, TransformerConfig


def _greedy_draft(draft_params: Params, draft_cfg: TransformerConfig,
                  cache: KVCache, last: torch.Tensor, draft_len: int,
                  mesh=None) -> tuple[torch.Tensor, KVCache]:
    """``draft_len`` greedy proposals from the draft model; ``last`` [B]
    is the most recent emitted token (the first input).  Runs
    ``draft_len + 1`` steps so the cache also holds the LAST proposal's
    K/V: on a full accept the position advances past it, and a missing
    row there would degrade every later draft.  Returns (proposals
    [B, draft_len], the cache advanced by draft_len + 1)."""
    token, drafts = last, []
    for _ in range(draft_len + 1):
        logits, cache = forward_with_cache(draft_params, token[:, None],
                                           draft_cfg, cache, mesh=mesh)
        token = logits[:, 0].argmax(dim=-1)
        drafts.append(token)
    return torch.stack(drafts[:draft_len], dim=1), cache


def _check(prompt: torch.Tensor, n_tokens: int, draft_len: int,
           max_seq: int, vocabs: tuple[int, int] | None = None) -> None:
    """The JAX loops' validation, in their order; ``vocabs`` is the
    (target, draft) vocab pair of a draft model."""
    tp = prompt.shape[1]
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    if vocabs is not None and vocabs[0] != vocabs[1]:
        raise ValueError("target and draft must share a vocab "
                         f"({vocabs[0]} != {vocabs[1]})")
    # the target writes up to draft_len + 1 speculative rows past the
    # emitted prefix; the caches must hold the worst case
    if tp + n_tokens + draft_len + 1 > max_seq:
        raise ValueError(
            f"prompt ({tp}) + n_tokens ({n_tokens}) + draft_len "
            f"({draft_len}) + 1 exceeds the {max_seq}-slot cache")


def _verify_loop(params: Params, cfg: TransformerConfig, prompt,
                 n_tokens: int, draft_len: int, max_seq: int, propose,
                 mesh=None):
    """The lockstep-minimum verify loop both sources share: prefill the
    target, then per iteration ``propose(last, accepted)`` drafts
    [B, draft_len] (``accepted`` is the previous iteration's batch
    acceptance + 1, or None before the first), the target scores
    [last, drafts] in one call, and every row advances by the batch's
    minimum acceptance + 1.  Returns ([B, Tp + n_tokens], iterations).
    ``mesh`` as :func:`speculative_generate` takes it."""
    b, tp = prompt.shape
    cache = init_cache(cfg, b, max_seq, device=_device(params), mesh=mesh)
    logits, cache = forward_with_cache(params, prompt, cfg, cache,
                                       first_chunk=True, mesh=mesh)
    last = logits[:, -1].argmax(dim=-1)
    out = torch.zeros((b, n_tokens + draft_len + 1), dtype=torch.long,
                      device=prompt.device)
    out[:, 0] = last
    count, iters, emitted = 1, 0, None
    while count < n_tokens:
        drafts = propose(last, emitted)
        # target logits at input i give its greedy choice for position
        # i + 1 of the window
        logits, cache = forward_with_cache(
            params, torch.cat([last[:, None], drafts], dim=1), cfg, cache,
            mesh=mesh)
        greedy = logits.argmax(dim=-1)
        acc = int((drafts == greedy[:, :-1]).long().cumprod(dim=1)
                  .sum(dim=1).min())
        emitted = acc + 1
        # the whole candidate block lands at the next free column; the
        # tail past acc + 1 is overwritten by the next iteration
        out[:, count:count + draft_len + 1] = greedy
        last = greedy[:, acc]
        # keep the written rows, move the position back to the
        # accepted prefix (stale rows are position-masked)
        cache = dataclasses.replace(cache, pos=cache.pos - draft_len - 1
                                    + emitted)
        count += emitted
        iters += 1
    tokens = torch.cat([prompt, out[:, :n_tokens].to(prompt.dtype)], dim=1)
    return tokens, iters


@torch.no_grad()
def speculative_generate(params: Params, draft_params: Params,
                         prompt: torch.Tensor, cfg: TransformerConfig,
                         draft_cfg: TransformerConfig, n_tokens: int,
                         draft_len: int = 4, max_seq: int | None = None,
                         mesh=None) -> tuple[torch.Tensor, int]:
    """prompt [B, Tp] -> ([B, Tp + n_tokens] greedy continuation of the
    TARGET model, iterations used).

    ``params``/``cfg`` is the target, ``draft_params``/``draft_cfg``
    the proposer (same vocab).  ``iterations`` counts target forwards:
    with a perfect draft it approaches ``n_tokens / (draft_len + 1)``.
    ``mesh``: both params are this rank's blocks under it (module
    docstring); every rank returns the same tokens and iterations."""
    max_seq = max_seq or cfg.max_seq
    _check(prompt, n_tokens, draft_len, max_seq,
           (cfg.vocab, draft_cfg.vocab))
    d_cache = init_cache(draft_cfg, prompt.shape[0], max_seq,
                         device=_device(draft_params), mesh=mesh)
    _, d_cache = forward_with_cache(draft_params, prompt, draft_cfg,
                                    d_cache, first_chunk=True, mesh=mesh)
    state = {"cache": d_cache}

    def propose(last, emitted):
        cache = state["cache"]
        if emitted is not None:
            # the previous draft advanced the cache by draft_len + 1;
            # keep its rows, move back to the accepted prefix
            cache = dataclasses.replace(
                cache, pos=cache.pos - draft_len - 1 + emitted)
        drafts, state["cache"] = _greedy_draft(draft_params, draft_cfg,
                                               cache, last, draft_len, mesh)
        return drafts

    return _verify_loop(params, cfg, prompt, n_tokens, draft_len, max_seq,
                        propose, mesh)


@torch.no_grad()
def ngram_speculative_generate(params: Params, prompt: torch.Tensor,
                               cfg: TransformerConfig, n_tokens: int,
                               draft_len: int = 4,
                               max_seq: int | None = None, mesh=None
                               ) -> tuple[torch.Tensor, int]:
    """Model-free speculative generation: :func:`speculative_generate`
    with the prompt n-gram lookup in place of the draft model (no
    second set of weights, no second cache; proposals are a gather over
    the prompt).  prompt [B, Tp] -> ([B, Tp + n_tokens] greedy
    continuation of the target, target-forward iterations), equal to
    ``greedy_generate`` whatever the lookup proposes; ``iterations``
    degrades to ``n_tokens`` at worst (one token a target forward).
    ``mesh`` as :func:`speculative_generate` takes it."""
    max_seq = max_seq or cfg.max_seq
    _check(prompt, n_tokens, draft_len, max_seq)
    b, tp = prompt.shape
    ctx = prompt.long()
    ctx_len = torch.full((b,), tp, dtype=torch.long, device=prompt.device)

    def propose(last, emitted):
        return ngram_propose_rows(ctx, ctx_len, last, draft_len)

    return _verify_loop(params, cfg, prompt, n_tokens, draft_len, max_seq,
                        propose, mesh)


__all__ = ["ngram_speculative_generate", "speculative_generate"]
