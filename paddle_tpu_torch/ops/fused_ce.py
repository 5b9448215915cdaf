"""Fused vocab-chunked cross entropy — port of ``paddle_tpu/ops/fused_ce.py``.

``loss(h @ Wᵀ, labels)`` without ever holding the ``[T, V]`` logits: the
forward streams W in vocab chunks with an online logsumexp in f32, and
the backward recomputes each chunk's softmax, so the peak extra memory is
one ``[T, V/chunks]`` f32 block. The chunk products are plain
``torch.matmul`` calls that accumulate and return f32 (the reference
leaves them to XLA with ``preferred_element_type=f32``); the loop over
chunks is Python, where the reference scans.

Returns PER-TOKEN losses (callers reduce), as
``F.cross_entropy(..., reduction='none')`` does for hard labels. The
chunk count is 8, or with ``FLAGS_use_autotune`` on the card the winner
of :func:`_auto_chunks`' sweep.

Over a vocab split by tensor parallelism (``group``: W holds this
rank's rows ``vocab_start .. vocab_start + V/mp``), each rank streams its
rows, and the row max, the sum of exponentials and the target logit are
all-reduced over the group (the reference leaves this partition to
GSPMD); the backward's ``dW`` is this rank's rows and its ``dh`` this
rank's part, which the caller sums over the group (``mpu.copy_to_group``
in front of ``h``).
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
    def forward(ctx, h, w, labels, valid, n_chunks, group=None):
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
        if group is not None:
            from paddle_tpu_torch.distributed import collective as C
            m_all = C.all_reduce(m.clone(), C.ReduceOp.MAX, group=group)
            s = C.all_reduce(s * torch.exp(m - m_all), group=group)
            lab = C.all_reduce(lab, group=group)
            m = m_all
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
        return dh.to(h.dtype), dw, None, None, None, None


def _auto_chunks(T, V, d, dtype, device) -> int:
    """The vocab chunk count for this signature (reference :113-141): the
    default 8, or with ``FLAGS_use_autotune`` on the card the winner of a
    sweep over the counts 4, 8, 16 and 32 that divide V, each timed
    forward and backward on zero operands and cached per ``(T, V, d,
    dtype)`` (``ops/pallas/autotune.py``). For CPU tensors: the default,
    with nothing swept."""
    from paddle_tpu_torch.core.flags import flag
    if not flag("use_autotune") or torch.device(device).type != "cuda":
        return _DEF_CHUNKS
    from paddle_tpu_torch.ops.pallas.autotune import autotune

    def build(nc):
        h0 = torch.zeros(T, d, dtype=dtype, device=device,
                         requires_grad=True)
        w0 = torch.zeros(V, d, dtype=dtype, device=device,
                         requires_grad=True)
        lab0 = torch.zeros(T, dtype=torch.long, device=device)
        valid0 = torch.ones(T, dtype=torch.bool, device=device)

        def run():
            with torch.enable_grad():
                loss = _MatmulCE.apply(h0, w0, lab0, valid0, nc).sum()
                return torch.autograd.grad(loss, (h0, w0))
        return run

    return autotune("fused_ce_chunks", (T, V, d, str(dtype)),
                    [c for c in (4, 8, 16, 32) if V % c == 0], build,
                    _DEF_CHUNKS)


def matmul_cross_entropy(h, w_vd, labels, ignore_index: int = -100,
                         n_chunks=None, group=None, vocab_start: int = 0):
    """Per-token CE of ``h @ w_vdᵀ`` against int ``labels``; over a
    vocab split on ``group``, ``w_vd`` is this rank's rows from
    ``vocab_start``.

    ``h``: [T, d] (or [..., d], flattened), ``w_vd``: [V, d] (the tied
    embedding's layout), ``labels``: int [T]. Tokens whose label equals
    ``ignore_index`` contribute zero loss and zero gradient.
    ``n_chunks`` must divide V, otherwise one chunk is used; ``None``
    picks the default (or the autotuned winner under
    ``FLAGS_use_autotune``).
    """
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    lab = torch.where(valid, lab, torch.zeros_like(lab))
    if group is not None:
        # a label outside this rank's rows is in no chunk here
        lab = torch.where(valid, lab - vocab_start, lab)
    V = w_vd.shape[0]
    n_chunks = _auto_chunks(h2.shape[0], V, h2.shape[1], h2.dtype,
                            h2.device) if n_chunks is None \
        else int(n_chunks)
    if V % n_chunks:
        n_chunks = 1
    loss = _MatmulCE.apply(h2, w_vd, lab, valid, n_chunks, group)
    return loss.reshape(lead)


def causal_lm_loss(h, w_vd, labels, ignore_index: int = -100, group=None,
                   vocab_start: int = 0):
    """Masked-mean causal-LM loss over the fused chunked matmul-CE:
    position t predicts token t+1; ``ignore_index`` positions contribute
    zero loss and zero denominator. ``h`` [B, S, d], ``w_vd`` [V, d]
    (this rank's rows from ``vocab_start`` over a split vocab)."""
    tgt = labels[:, 1:].reshape(-1)
    per_tok = matmul_cross_entropy(
        h[:, :-1, :].reshape(-1, h.shape[-1]), w_vd, tgt,
        ignore_index=ignore_index, group=group, vocab_start=vocab_start)
    valid = (tgt != ignore_index).to(per_tok.dtype)
    return per_tok.sum() / torch.clamp(valid.sum(), min=1.0)
