"""Speculative decoding (draft-and-verify) for the transformer LM.

The counterpart of ``elephas_tpu/models/speculative.py``. A small draft
model proposes ``gamma`` tokens autoregressively on its own contiguous
cache; the target model scores all of them in ONE cached block forward
(:func:`~elephas_tpu_torch.models.transformer.decode_block`, or
:func:`~elephas_tpu_torch.models.paged_decode.decode_block_paged` over a
block pool) and keeps the longest accepted prefix plus one token of its
own. Greedy verification reproduces the target's greedy decode exactly
(f32); temperature sampling uses the rejection rule of speculative
sampling (accept draft token ``x`` with probability ``min(1,
p_target(x)/p_draft(x))``, on rejection resample from ``norm(max(p_target
- p_draft, 0))``), whose output distribution equals sampling from the
target alone.

Where the JAX package runs the whole decode as one jitted
``lax.while_loop``, :func:`speculative_generate` here is a Python loop of
rounds on the device, with one device-to-host read per round (the loop
condition). Random draws come from an explicit ``torch.Generator`` (the
JAX PRNG key's counterpart; the two streams differ). Rows accept
different numbers of tokens per round, so per-row cache positions ride
the vector-``pos`` support of ``decode_step`` / ``decode_block``; stale
entries past a row's position are masked by the causal length mask and
overwritten before they can be attended, so nothing rolls back.
"""
from typing import Dict, Optional

import torch

from .paged_decode import decode_block_paged
from .transformer import (TransformerConfig, decode_block, decode_step,
                          prefill_cache)

__all__ = ["speculative_generate", "speculative_round",
           "speculative_round_paged"]


def _pick(logits: torch.Tensor, key: Optional[torch.Generator],
          temperature: float, greedy: bool):
    """``(tokens (B,), key)``: the argmax, or a draw from
    ``softmax(logits / temperature)`` with ``key`` (advanced in place)."""
    if greedy:
        return torch.argmax(logits, dim=-1), key
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=key)[:, 0], key


def _draft_propose(draft_params: Dict, d_cache: Dict, last: torch.Tensor,
                   p: torch.Tensor, gamma: int,
                   draft_config: TransformerConfig, temperature: float, key,
                   greedy: bool):
    """The draft half of a round: propose ``gamma`` tokens
    autoregressively on the draft's own contiguous cache. Returns ``(d
    (B, gamma), d_logits list, d_cache, key)``."""
    dc = draft_config
    tok, d_toks, d_logits = last, [], []
    for j in range(gamma):
        lg, d_cache = decode_step(draft_params, d_cache, tok, p + j, dc)
        tok, key = _pick(lg, key, temperature, greedy)
        d_toks.append(tok)
        d_logits.append(lg)
    # cache-advance: process the last proposal too, so a fully accepted
    # round leaves no k/v hole at the next round's start
    _, d_cache = decode_step(draft_params, d_cache, tok, p + gamma, dc)
    return torch.stack(d_toks, dim=1), d_logits, d_cache, key


def speculative_round(params: Dict, draft_params: Dict, t_cache: Dict,
                      d_cache: Dict, last: torch.Tensor, p: torch.Tensor,
                      gamma: int, config: TransformerConfig,
                      draft_config: TransformerConfig, temperature: float,
                      key, greedy: bool):
    """One draft-propose / target-verify round at per-row positions.

    ``last`` ``(B,)`` is each row's last emitted token, sitting at
    position ``p`` ``(B,)`` (neither cache has processed it yet; both
    are valid below ``p``). Returns ``(emit, a, nxt, t_cache, d_cache,
    key)``: row ``b`` emits ``emit[b, :a[b] + 1]`` (its accepted draft
    prefix with the target's own token at slot ``a[b]``) and continues
    from ``nxt == emit[b, a[b]]`` at position ``p + a + 1``. Both caches
    are written in place."""
    d, d_logits, d_cache, key = _draft_propose(
        draft_params, d_cache, last, p, gamma, draft_config, temperature,
        key, greedy)
    block = torch.cat([last[:, None], d], dim=1)
    t_logits, t_cache = decode_block(params, t_cache, block, p, config)
    emit, a, nxt, key = _verify_emit(t_logits, d, d_logits, gamma,
                                     temperature, key, greedy)
    return emit, a, nxt, t_cache, d_cache, key


def speculative_round_paged(params: Dict, draft_params: Dict, pool: Dict,
                            tables: torch.Tensor, d_cache: Dict,
                            last: torch.Tensor, p: torch.Tensor, gamma: int,
                            config: TransformerConfig,
                            draft_config: TransformerConfig,
                            temperature: float, key, greedy: bool):
    """:func:`speculative_round` over a PAGED target cache: the verify
    pass runs :func:`~elephas_tpu_torch.models.paged_decode.
    decode_block_paged` against each row's block table, writing the
    round's ``gamma + 1`` positions into the row's OWN blocks (the verify
    slack the serving engine budgets per slot). Returns ``(emit, a, nxt,
    pool, d_cache, key)``, the contiguous round's contract with the pool
    in the target cache's place."""
    d, d_logits, d_cache, key = _draft_propose(
        draft_params, d_cache, last, p, gamma, draft_config, temperature,
        key, greedy)
    block = torch.cat([last[:, None], d], dim=1)
    t_logits, pool = decode_block_paged(params, pool, tables, block, p,
                                        config)
    emit, a, nxt, key = _verify_emit(t_logits, d, d_logits, gamma,
                                     temperature, key, greedy)
    return emit, a, nxt, pool, d_cache, key


def _verify_emit(t_logits: torch.Tensor, d: torch.Tensor, d_logits,
                 gamma: int, temperature: float, key, greedy: bool):
    """The accept/resample rule on the target's verify logits ``(B,
    gamma + 1, V)``: shared by the contiguous and paged rounds."""
    b = d.shape[0]
    if greedy:
        tgt = torch.argmax(t_logits, dim=-1)
        match = (tgt[:, :gamma] == d).to(torch.int64)
        a = torch.cumprod(match, dim=1).sum(dim=1)   # agreeing prefix
        nxt = torch.gather(tgt, 1, a[:, None])[:, 0]
    else:
        dl = torch.stack(d_logits, dim=1)            # (B, gamma, V)
        pt = torch.softmax(t_logits / temperature, dim=-1)
        pd = torch.softmax(dl / temperature, dim=-1)
        pt_d = torch.gather(pt[:, :gamma], 2, d[..., None])[..., 0]
        pd_d = torch.gather(pd, 2, d[..., None])[..., 0]
        u = torch.rand((b, gamma), generator=key, device=d.device)
        # accept iff u < pt/pd, written multiplication-safe
        a = torch.cumprod((u * pd_d < pt_d).to(torch.int64),
                          dim=1).sum(dim=1)
        # resample slot: norm(max(pt - pd, 0)); past the last draft slot
        # (a == gamma) pd is zero and this is the target's bonus token
        pd_pad = torch.cat([pd, torch.zeros_like(pt[:, :1])], dim=1)
        idx = a[:, None, None].expand(-1, 1, pt.shape[-1])
        res = torch.clamp(torch.gather(pt, 1, idx)[:, 0]
                          - torch.gather(pd_pad, 1, idx)[:, 0], min=0.0)
        res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-20)
        # + 1e-30: the JAX package draws from log(res + 1e-30), so an
        # all-zero row (pt == pd) draws uniformly there and here
        nxt = torch.multinomial(res + 1e-30, 1, generator=key)[:, 0]
    # emit = the accepted prefix with the target's token at slot a
    slots = torch.arange(gamma + 1, device=d.device)[None, :]
    d_pad = torch.cat([d, torch.zeros_like(nxt[:, None])], dim=1)
    emit = torch.where(slots == a[:, None], nxt[:, None], d_pad)
    return emit, a, nxt, key


def _spec_loop(params: Dict, draft_params: Dict, prompt: torch.Tensor,
               temperature: float, key, max_new_tokens: int, gamma: int,
               config: TransformerConfig, draft_config: TransformerConfig,
               greedy: bool):
    """The rounds of :func:`speculative_generate` as a host loop over
    device tensors: ``(tokens (B, max_new), rounds, accepted,
    proposed)``."""
    c, dc = config, draft_config
    device = prompt.device
    b, prompt_len = prompt.shape
    # worst-case write position: a row clamped at count=max_new keeps
    # verifying blocks at p..p+gamma with p = prompt_len-1+max_new
    cache_len = prompt_len + max_new_tokens + gamma
    t_logits0, t_cache = prefill_cache(params, prompt, c, cache_len)
    _, d_cache = prefill_cache(draft_params, prompt, dc, cache_len)

    n0, key = _pick(t_logits0, key, temperature, greedy)
    # one column past the last real index takes the writes the JAX
    # scatter drops (rejected slots), and is sliced off
    sink = max_new_tokens + gamma + 1
    out = torch.zeros((b, sink + 1), dtype=torch.long, device=device)
    out[:, 0] = n0
    count = torch.ones(b, dtype=torch.long, device=device)
    last = n0
    rows = torch.arange(b, device=device)[:, None]
    slots = torch.arange(gamma + 1, device=device)[None, :]
    rounds = 0
    acc = torch.zeros((), dtype=torch.long, device=device)
    props = torch.zeros((), dtype=torch.long, device=device)
    while int(count.min()) < max_new_tokens:
        # rows already at max_new idle while slower rows catch up; their
        # proposals are meaningless and stay out of the acceptance stat
        active = count < max_new_tokens
        p = prompt_len - 1 + count
        emit, a, nxt, t_cache, d_cache, key = speculative_round(
            params, draft_params, t_cache, d_cache, last, p, gamma, c, dc,
            temperature, key, greedy)
        idx = torch.where(slots <= a[:, None], count[:, None] + slots, sink)
        out[rows, idx] = emit
        # clamp: finished rows idle in place (their writes land past
        # max_new and are sliced off)
        count = torch.clamp(count + a + 1, max=max_new_tokens)
        last = nxt
        rounds += 1
        acc = acc + torch.where(active, a, 0).sum()
        props = props + gamma * active.sum()
    return out[:, :max_new_tokens], rounds, int(acc), int(props)


@torch.no_grad()
def speculative_generate(params: Dict, draft_params: Dict, prompt,
                         max_new_tokens: int, config: TransformerConfig,
                         draft_config: TransformerConfig, gamma: int = 4,
                         temperature: float = 0.0,
                         key: Optional[torch.Generator] = None,
                         return_stats: bool = False):
    """Decode ``(batch, prompt_len)`` prompts with a draft model
    proposing ``gamma`` tokens per round and the target verifying them
    in one block forward; returns ``(batch, max_new_tokens)`` int64 token
    ids on the device of ``params`` (plus ``{"rounds",
    "draft_acceptance"}`` with ``return_stats``).

    ``temperature=0`` is greedy and reproduces the target's own greedy
    decode token for token (in f32; under bf16 the verify block and
    ``generate``'s steps round differently, so an argmax near-tie can
    resolve differently); ``temperature>0`` is speculative sampling,
    distributed as sampling the target alone, drawing from ``key`` (a
    ``torch.Generator`` on the params' device, required).
    ``draft_acceptance`` is the fraction of draft proposals accepted:
    emitted tokens per target-weight read is ``1 + gamma *
    acceptance``. Uniform-length prompts only; both models share a
    vocabulary."""
    c, dc = config, draft_config
    device = params["embed"]["tokens"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    _, prompt_len = prompt.shape
    if dc.vocab_size != c.vocab_size:
        raise ValueError(
            f"draft vocab {dc.vocab_size} != target vocab {c.vocab_size}")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    total = prompt_len + max_new_tokens + gamma
    for name, cfg in (("target", c), ("draft", dc)):
        if total > cfg.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens + gamma = {total} exceeds "
                f"{name} max_seq_len = {cfg.max_seq_len}")
    greedy = not temperature > 0      # <= 0 is greedy, matching generate()
    if not greedy and key is None:
        raise ValueError("sampling (temperature > 0) requires a "
                         "torch.Generator key")
    tokens, rounds, acc, props = _spec_loop(
        params, draft_params, prompt, float(temperature), key,
        int(max_new_tokens), int(gamma), c, dc, greedy)
    if not return_stats:
        return tokens
    return tokens, {"rounds": rounds,
                    "draft_acceptance": acc / max(props, 1)}
