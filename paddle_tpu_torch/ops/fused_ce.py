"""Fused vocab-chunked cross entropy — port of ``paddle_tpu/ops/fused_ce.py``.

``loss(h @ Wᵀ, labels)`` without ever holding the ``[T, V]`` logits: the
forward streams W in vocab chunks with an online logsumexp in f32, and
the backward recomputes each chunk's softmax, so the peak extra memory is
one ``[T, V/chunks]`` f32 block. The chunk products are plain
``torch.matmul`` calls that accumulate and return f32 (the reference
leaves them to XLA with ``preferred_element_type=f32``); the loop over
chunks is Python, where the reference scans.

Returns PER-TOKEN losses (callers reduce), as
``F.cross_entropy(..., reduction='none')`` does for hard labels.
"""
from __future__ import annotations

import torch

__all__ = ["matmul_cross_entropy", "causal_lm_loss"]

_DEF_CHUNKS = 8


def _mm_f32(a, b):
    """``a @ b`` accumulated in and returned as f32. bf16 and f16
    operands stay in their type on the card (the tensor cores accumulate
    in f32); on the CPU they are widened, which is exact."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, valid, n_chunks):
        T = h.shape[0]
        vc = w.shape[0] // n_chunks
        m = torch.full((T,), float("-inf"), device=h.device)
        s = torch.zeros(T, device=h.device)
        lab = torch.zeros(T, device=h.device)
        rows = torch.arange(T, device=h.device)
        for c in range(n_chunks):
            start = c * vc
            logits = _mm_f32(h, w[start:start + vc].t())  # [T, vc]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = torch.clamp(labels - start, 0, vc - 1)
            in_chunk = (labels >= start) & (labels < start + vc)
            lab = torch.where(in_chunk, logits[rows, idx], lab)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, labels, valid, lse)
        ctx.n_chunks = n_chunks
        # ignored tokens: zero loss (callers divide by the valid count)
        return torch.where(valid, lse - lab, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, dout):
        h, w, labels, valid, lse = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        vc = w.shape[0] // n_chunks
        dout = dout.float() * valid.float()  # ignored tokens: zero grad
        rows = torch.arange(h.shape[0], device=h.device)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(w)
        for c in range(n_chunks):
            start = c * vc
            wc = w[start:start + vc]
            p = torch.exp(_mm_f32(h, wc.t()) - lse[:, None])  # recomputed
            in_chunk = (labels >= start) & (labels < start + vc)
            idx = torch.clamp(labels - start, 0, vc - 1)
            # p - onehot(label), only where the label falls in this chunk
            p[rows, idx] -= in_chunk.float()
            g = (p * dout[:, None]).to(h.dtype)
            dh += _mm_f32(g, wc)
            dw[start:start + vc] = _mm_f32(g.t(), h).to(w.dtype)
        return dh.to(h.dtype), dw, None, None, None


def matmul_cross_entropy(h, w_vd, labels, ignore_index: int = -100,
                         n_chunks=None):
    """Per-token CE of ``h @ w_vdᵀ`` against int ``labels``.

    ``h``: [T, d] (or [..., d], flattened), ``w_vd``: [V, d] (the tied
    embedding's layout), ``labels``: int [T]. Tokens whose label equals
    ``ignore_index`` contribute zero loss and zero gradient.
    ``n_chunks`` (default 8) must divide V; otherwise one chunk is used.
    """
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    lab = torch.where(valid, lab, torch.zeros_like(lab))
    V = w_vd.shape[0]
    n_chunks = _DEF_CHUNKS if n_chunks is None else int(n_chunks)
    if V % n_chunks:
        n_chunks = 1
    loss = _MatmulCE.apply(h2, w_vd, lab, valid, n_chunks)
    return loss.reshape(lead)


def causal_lm_loss(h, w_vd, labels, ignore_index: int = -100):
    """Masked-mean causal-LM loss over the fused chunked matmul-CE:
    position t predicts token t+1; ``ignore_index`` positions contribute
    zero loss and zero denominator. ``h`` [B, S, d], ``w_vd`` [V, d]."""
    tgt = labels[:, 1:].reshape(-1)
    per_tok = matmul_cross_entropy(
        h[:, :-1, :].reshape(-1, h.shape[-1]), w_vd, tgt,
        ignore_index=ignore_index)
    valid = (tgt != ignore_index).to(per_tok.dtype)
    return per_tok.sum() / torch.clamp(valid.sum(), min=1.0)
