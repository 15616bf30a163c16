"""Speculative decoding over dense caches: a draft proposes, the target verifies.

Port of ``unionml_tpu/models/speculative.py:44-240``. Each round the draft
decodes ``gamma`` proposals and the target scores ``[last token, proposals]``
in ONE chunked forward; the accepted prefix advances the sequence by up to
``gamma + 1`` tokens per target pass.

- ``temperature=0`` (greedy): the output is exactly target-only greedy
  decoding, token for token, whatever the draft.
- ``temperature>0``: the accept/residual rule (accept proposal ``x`` with
  probability ``min(1, p_target(x) / p_draft(x))``, else sample the normalized
  positive residual ``max(p_target - p_draft, 0)``), so every emitted token is
  a sample of the target's distribution. Random numbers come from a
  ``torch.Generator``, so sampled streams match the JAX package in
  distribution, not bitwise.

Cache discipline (both models): after a round the caches hold positions
``[0, n)`` of the ``n`` tokens FED; the newest emitted token enters at the
start of the next round. Rejected columns past ``n`` are never attended (the
chunk mask is positional) and are overwritten later. Batch 1 only: rows would
accept prefixes of different lengths (the paged engine's
:class:`~unionml_tpu_torch.serving.speculative.SpeculativeEngine` batches).
"""

from typing import Any, Optional

import torch

__all__ = ["speculative_generate"]


def _prefill(model, prompt_ids: torch.Tensor, max_len: int):
    from unionml_tpu_torch.models.gpt import init_cache

    cache = init_cache(model.config, prompt_ids.shape[0], max_len, device=model.device)
    logits, cache = model(prompt_ids, cache=cache, position=0)
    return cache, logits[:, -1, :]


def _select(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


@torch.no_grad()
def speculative_generate(
    target: Any,
    draft: Any,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_stats: bool = False,
) -> Any:
    """Decode ``max_new_tokens`` from ``target`` with ``draft`` speculation.

    :param target: the model whose distribution is authoritative
        (:class:`~unionml_tpu_torch.models.gpt.GPTLMHeadModel`).
    :param draft: a cheaper model on the target's vocabulary and device.
    :param prompt_ids: ``(1, prompt_len)`` token ids.
    :param gamma: proposals per round; a round costs ``gamma`` draft steps and
        one target forward over ``gamma + 1`` tokens and advances 1 to
        ``gamma + 1`` tokens.
    :param generator: draws for ``temperature > 0``.
    :param return_stats: also return ``{"rounds", "proposed", "accepted",
        "acceptance_rate"}``.
    :returns: ``(1, prompt_len + max_new_tokens)`` ids, as
        :func:`~unionml_tpu_torch.models.gpt.generate` returns, or ``(ids, stats)``.
    """
    if prompt_ids.dim() != 2 or prompt_ids.shape[0] != 1:
        raise ValueError(f"speculative_generate expects (1, prompt_len) ids; got {tuple(prompt_ids.shape)}")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    if target.config.vocab_size != draft.config.vocab_size:
        raise ValueError(f"draft vocab ({draft.config.vocab_size}) must match target ({target.config.vocab_size})")
    prompt_len = prompt_ids.shape[1]
    # speculation overshoots by up to gamma rejected columns; reserve the slack
    max_len = prompt_len + max_new_tokens + gamma + 1
    for cfg, name in ((target.config, "target"), (draft.config, "draft")):
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"prompt + max_new_tokens + gamma ({max_len}) exceeds the {name}'s "
                             f"max_position_embeddings ({cfg.max_position_embeddings})")
    prompt_ids = prompt_ids.to(target.device).long()
    target_cache, t_logits = _prefill(target, prompt_ids, max_len)
    draft_cache, _ = _prefill(draft, prompt_ids, max_len)
    emitted = [int(_select(t_logits, temperature, generator)[0])]
    prev = int(prompt_ids[0, -1])  # the penultimate committed token (see below)
    n = prompt_len
    rounds = accepted_total = 0
    device = prompt_ids.device
    while len(emitted) < max_new_tokens:
        # propose: feed the last two committed tokens (the second backfills the
        # final proposal a full-accept round never fed the draft), then decode
        feed = torch.tensor([[prev, emitted[-1]]], device=device)
        logits, draft_cache = draft(feed, cache=draft_cache, position=n - 1)
        rows = [logits[:, -1, :]]
        proposals = [_select(rows[0], temperature, generator)]
        for j in range(1, gamma):
            logits, draft_cache = draft(proposals[-1][:, None], cache=draft_cache, position=n + j)
            rows.append(logits[:, -1, :])
            proposals.append(_select(rows[-1], temperature, generator))
        props = torch.cat(proposals)  # (gamma,)
        # verify: one chunked target forward over [last token, proposals]
        chunk = torch.cat([torch.tensor([emitted[-1]], device=device), props])[None, :]
        logits, target_cache = target(chunk, cache=target_cache, position=n)
        t_rows = logits[0]  # (gamma + 1, vocab): t_rows[i] follows chunk[i]
        if temperature <= 0.0:
            preds = torch.argmax(t_rows, dim=-1)
            a = int(torch.cumprod((preds[:-1] == props).long(), dim=0).sum())
            closer = int(preds[a])  # the correction on a mismatch, the bonus when a == gamma
        else:
            p_t = torch.softmax(t_rows[:-1].float() / temperature, dim=-1)
            p_d = torch.softmax(torch.cat(rows).float() / temperature, dim=-1)
            idx = torch.arange(gamma, device=device)
            u = torch.rand(gamma, generator=generator, device=device)
            ok = u * p_d[idx, props] < p_t[idx, props]  # u < p_t/p_d without the 0/0 division
            a = int(torch.cumprod(ok.long(), dim=0).sum())
            if a == gamma:
                closer = int(_select(t_rows[-1:], temperature, generator)[0])
            else:
                resid = torch.clamp_min(p_t[a] - p_d[a], 0.0)
                closer = int(torch.multinomial(resid / torch.clamp_min(resid.sum(), 1e-20), 1, generator=generator))
        emitted.extend(props[:a].tolist() + [closer])
        prev = emitted[-2]
        n += a + 1
        rounds += 1
        accepted_total += a
    out = torch.cat([prompt_ids, torch.tensor([emitted[:max_new_tokens]], device=device)], dim=1)
    if return_stats:
        proposed = rounds * gamma
        return out, {"rounds": rounds, "proposed": proposed, "accepted": accepted_total,
                     "acceptance_rate": accepted_total / proposed if proposed else 0.0}
    return out
