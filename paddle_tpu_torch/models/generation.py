"""Autoregressive decoding — port of ``paddle_tpu/models/generation.py``:
the eager ``generate_loop`` (:63) behind ``LlamaForCausalLM.generate``,
and the helpers the serving engine shares (``decode_surfaces``,
``sample_token``). The compiled loop (``compiled_generate``) waits for
CUDA-graph capture (ROADMAP §1 item 1).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.generator import torch_generator

__all__ = ["decode_surfaces", "sample_token", "generate_loop"]


def decode_surfaces(model):
    """``(backbone, project, dtype)`` for a Llama causal LM: the trunk at
    ``model.model``, its ``_logits`` projector, and the embedding
    weight's dtype (the KV-cache dtype). The reference's branch for the
    MoE LM waits for the MoE slice."""
    return model.model, model._logits, model.model.embed_tokens.weight.dtype


def sample_token(step_logits, temperature: float, top_k: int,
                 top_p: float, generator: torch.Generator):
    """[B, V] logits -> [B] token ids (greedy when ``temperature == 0``),
    with top-k and nucleus filtering as in the reference; the draw comes
    from the explicit ``generator``. A ``top_k`` above V, and a ``top_p``
    so close to 1 that the f32 cumulative sum never reaches it, filter
    nothing, as the reference's clamped indexing does."""
    if temperature == 0:
        return torch.argmax(step_logits, dim=-1)
    sl = step_logits.float() / temperature
    V = sl.shape[-1]
    if top_k > 0:
        kth = torch.sort(sl, dim=-1).values[:, -min(top_k, V)][:, None]
        sl = torch.where(sl < kth, torch.full_like(sl, -float("inf")), sl)
    if top_p < 1.0:
        srt = torch.sort(sl, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1).clamp(max=V - 1)
        cutoff = torch.gather(srt, -1, cutoff_idx[:, None])
        sl = torch.where(sl < cutoff, torch.full_like(sl, -float("inf")),
                         sl)
    probs = torch.softmax(sl, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate_loop(prefill, decode, input_ids, max_new_tokens: int = 32,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, eos_token_id=None) -> torch.Tensor:
    """The full sequence ``[B, S + new]``, prompt included. A model
    plugs in ``prefill(ids) -> (logits [B, 1, V], caches)`` and
    ``decode(tok [B, 1], caches) -> (logits [B, 1, V], caches)``.

    The tokens stay on the model's device, so without ``eos_token_id``
    the loop never waits for the card. With it, the loop exits once
    every row has emitted ``eos_token_id`` (rows that finish first pad
    with it), so ``new`` is the step count taken, and no decode runs past
    the last useful step, as in the reference."""
    with torch.no_grad():
        logits, caches = prefill(input_ids)
        out = input_ids.long()
        gen = torch_generator(out.device) if temperature != 0 else None
        finished = torch.zeros(out.shape[0], dtype=torch.bool,
                               device=out.device)
        for i in range(max_new_tokens):
            nxt = sample_token(logits[:, 0], temperature, top_k, top_p,
                               gen).long()
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                                  nxt)
                finished |= nxt == eos_token_id
            out = torch.cat([out, nxt[:, None]], dim=1)
            if i == max_new_tokens - 1 or (eos_token_id is not None
                                           and bool(finished.all())):
                break  # the budget is spent: skip the unused forward
            logits, caches = decode(nxt[:, None], caches)
        return out
