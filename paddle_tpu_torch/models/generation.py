"""Decode helpers shared by the serving engine — port of the matching
functions in ``paddle_tpu/models/generation.py``. The eager and compiled
generate loops (with their KV-cached attention paths) are not ported
yet."""
from __future__ import annotations

import torch

__all__ = ["decode_surfaces", "sample_token"]


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
