"""Autoregressive decoding — port of ``paddle_tpu/models/generation.py``:
the eager ``generate_loop`` (:63) behind ``LlamaForCausalLM.generate``,
the compiled loop ``compiled_generate`` (:94-268) behind
``generate_compiled``, and the helpers the serving engine shares
(``decode_surfaces``, ``sample_token``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.core.generator import torch_generator

__all__ = ["decode_surfaces", "sample_token", "generate_loop",
           "compiled_generate"]

#: the most compiled_generate signatures a model keeps (LRU-evicted)
_COMPILED_CACHE_CAP = 16


def decode_surfaces(model):
    """``(backbone, project, dtype)``: the zoo family seam of every
    cached decode path (``compiled_generate`` and the serving engine;
    reference :22-36). Llama keeps its trunk at ``model.model`` with a
    ``_logits`` projector; the MoE LM's cached forward lives on the model
    itself, with an ``lm_head``. ``dtype`` is the embedding weight's (the
    KV-cache dtype)."""
    backbone = getattr(model, "model", None)
    if backbone is None or not callable(backbone):
        backbone = model
    project = model._logits if hasattr(model, "_logits") else model.lm_head
    return backbone, project, backbone.embed_tokens.weight.dtype


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


def _left_padding(attention_mask, B, S):
    """``attention_mask`` ``[B, S]`` as bool, checked on the host: each
    row pads then tokens, the last column real (reference :190-203).
    Returns it and the per-row pad counts."""
    am = np.asarray(attention_mask.detach().cpu()
                    if isinstance(attention_mask, torch.Tensor)
                    else attention_mask).astype(bool)
    if am.shape != (B, S):
        raise ValueError(f"attention_mask shape {am.shape} != ids {(B, S)}")
    if not am[:, -1].all() or \
            (np.diff(am.astype(np.int8), axis=1) < 0).any():
        raise ValueError(
            "attention_mask must be LEFT-padded (0s then 1s per row, last "
            "column all real) — right-align the prompts")
    return am, (S - am.sum(1)).astype(np.int32)


class _Compiled:
    """One signature's static state: the KV buffers, the write position,
    the key mask and RoPE offsets of a ragged batch, the decode step's
    token, finished flags, outputs and step index, all on the model's
    device, and on the card the decode step's CUDA graph."""

    def __init__(self, model, B, S, mnt, dtype, device, ragged, pick_cfg):
        cfg = model.cfg
        n_kv = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        L = S + mnt
        kw = dict(device=device)
        self.model, self.S, self.mnt = model, S, mnt
        self.kv = [(torch.zeros(B, L, n_kv, hd, dtype=dtype, **kw),
                    torch.zeros(B, L, n_kv, hd, dtype=dtype, **kw))
                   for _ in range(cfg.num_hidden_layers)]
        self.pos = torch.zeros((), dtype=torch.int32, **kw)
        self.km = torch.zeros(B, L, dtype=torch.bool, **kw) if ragged \
            else None
        self.po = torch.zeros(B, dtype=torch.int32, **kw) if ragged \
            else None
        self.tok = torch.zeros(B, dtype=torch.long, **kw)
        self.finished = torch.zeros(B, dtype=torch.bool, **kw)
        self.out = torch.zeros(B, mnt, dtype=torch.long, **kw)
        self.step = torch.zeros((), dtype=torch.long, **kw)
        self.temperature, self.top_k, self.top_p, self.eos = pick_cfg
        self.gen = torch_generator(device) if self.temperature != 0 \
            else None
        self.graph = None
        self.pointers = None

    def run_model(self, toks):
        """The backbone over ``toks`` at the current position, the
        position moved on in place; the last position's logits."""
        backbone, project, _ = decode_surfaces(self.model)
        caches = [(k, v, self.pos) for k, v in self.kv]
        # a ragged batch's mask and offsets, which the MoE LM's forward
        # does not take (as in the reference)
        kw = {} if self.km is None else dict(attention_mask=self.km,
                                             pos_offsets=self.po)
        h, _ = backbone(toks, caches=caches, **kw)
        self.pos.add_(toks.shape[1])
        return project(h[:, -1:, :])

    def pick(self, logits):
        """The next token into ``tok`` (eos for finished rows, which stay
        finished) and into ``out`` at the step index."""
        nxt = sample_token(logits[:, -1, :].float(), self.temperature,
                           self.top_k, self.top_p, self.gen).long()
        if self.eos is not None:
            nxt = torch.where(self.finished,
                              torch.full_like(nxt, self.eos), nxt)
            self.finished |= nxt == self.eos
        self.tok.copy_(nxt)
        self.out.index_copy_(1, self.step.reshape(1), nxt[:, None])
        self.step.add_(1)

    def decode_step(self):
        """One decode step, every index on the card: the token decoded
        last was written at buffer index ``S + step - 1`` and turns live
        as a key; the backbone runs on it; the next token is picked."""
        if self.km is not None:
            self.km.index_fill_(1, (self.step + (self.S - 1)).reshape(1),
                                True)
        self.pick(self.run_model(self.tok[:, None]))


def compiled_generate(model, input_ids, max_new_tokens: int = 32,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, eos_token_id=None,
                      prefill_chunk: int = 0,
                      attention_mask=None) -> torch.Tensor:
    """The prompt and ``max_new_tokens`` new tokens, ``[B, S + new]``,
    over static KV buffers (reference :94-268, the whole loop as one XLA
    program there).

    The buffers are ``[B, S + new, n_kv, hd]``, written in place at a
    position held on the card. The prefill runs once, in one shot or in
    ``prefill_chunk``-token chunks through the same buffers (the chunk
    must divide S; a chunk of S or more is one shot, outputs equal). The
    decode step, sampling and eos logic included, runs with its step
    index on the card and reads nothing back on the host: on the card it
    is captured as one CUDA graph per signature (after a first, real step
    as its warm-up) and replayed for every later step; on the CPU it runs
    eagerly. Greedy decoding (``temperature == 0``) draws nothing from
    the generator and equals ``generate_loop``'s tokens; sampling draws
    from ``core.generator``'s stream of the card, registered with the
    graph. ``eos_token_id``: finished rows keep emitting it and the whole
    budget runs (no early exit).

    ``attention_mask`` ``[B, S]`` (1 real, 0 pad) serves a batch of
    unequal prompts, left-padded (checked on the host; right padding
    raises): per-row RoPE offsets put each row's first real token at
    position 0 and a key mask keeps pads out, generated slots turning
    live as they are written, so each row equals its prompt's solo run.
    The mask is an input: batches with other pad patterns share one
    entry. A model keeps the entries of its last ``_COMPILED_CACHE_CAP``
    signatures (batch, prompt length, budget, sampling, eos, dtype,
    chunk, raggedness, state names), least recently used out first."""
    backbone, project, dtype = decode_surfaces(model)
    device = backbone.embed_tokens.weight.device
    ids = torch.as_tensor(input_ids).to(device).long()
    B, S = int(ids.shape[0]), int(ids.shape[1])
    mnt = int(max_new_tokens)
    if mnt <= 0:
        raise ValueError("max_new_tokens must be positive")
    ragged = attention_mask is not None
    if ragged:
        am, pads = _left_padding(attention_mask, B, S)
    if prefill_chunk:
        if prefill_chunk <= 0 or S % prefill_chunk:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must divide the prompt "
                f"length {S}")
        if prefill_chunk >= S:
            prefill_chunk = 0  # one shot: share that entry
    pick_cfg = (float(temperature), int(top_k), float(top_p), eos_token_id)
    names = tuple(sorted(n for n, _ in model.named_parameters())) + \
        tuple(sorted(n for n, _ in model.named_buffers()))
    sig = (B, S, mnt, *pick_cfg, str(dtype), int(prefill_chunk), ragged,
           names)
    cache = model.__dict__.setdefault("_compiled_generate", OrderedDict())
    if sig in cache:
        cache.move_to_end(sig)
    else:
        cache[sig] = _Compiled(model, B, S, mnt, dtype, device, ragged,
                               pick_cfg)
        while len(cache) > _COMPILED_CACHE_CAP:
            cache.popitem(last=False)
    c = cache[sig]
    with torch.no_grad():
        for k, v in c.kv:
            k.zero_()
            v.zero_()
        c.pos.zero_()
        c.step.zero_()
        c.finished.zero_()
        if ragged:
            c.km.zero_()
            c.km[:, :S] = torch.from_numpy(am).to(device)
            c.po.copy_(torch.from_numpy(pads))
        if prefill_chunk:
            for c0 in range(0, S, prefill_chunk):
                logits = c.run_model(ids[:, c0:c0 + prefill_chunk])
        else:
            logits = c.run_model(ids)
        c.pick(logits)
        steps = mnt - 1
        if steps and device.type == "cuda":
            pointers = tuple(t.data_ptr() for t in (*model.parameters(),
                                                    *model.buffers()))
            if c.graph is None or c.pointers != pointers:
                from paddle_tpu_torch.jit.cuda_graph import CapturedGraph
                c.graph = CapturedGraph(
                    c.decode_step, device,
                    generators=() if c.gen is None else (c.gen,))
                c.graph.capture()  # its warm-up is the first decode step
                c.pointers = pointers
                steps -= 1
            for _ in range(steps):
                c.graph.replay()
        else:
            for _ in range(steps):
                c.decode_step()
        return torch.cat([ids, c.out.clone()], dim=1)
