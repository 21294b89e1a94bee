"""Streaming (vocab-chunked) softmax cross entropy: the counterpart of
``horovod_tpu/ops/loss.py``.

Computes the mean cross entropy (with optional label smoothing) without an
fp32 tensor of the logits' size:

- forward: one pass over vocab chunks with an online max/sum-exp, carrying
  three ``[tokens]`` fp32 vectors; the label logit comes from one gather;
- backward: ``d_logits = (softmax * target_mass - target) * g / tokens``
  written chunk by chunk in the logits' own dtype.

Out-of-range labels (e.g. -1 as padding) follow one-hot semantics: zero
target mass, so without smoothing they add nothing to loss or gradient;
with smoothing they keep the uniform eps/V component.
"""
from __future__ import annotations

import torch


def _pick_chunk(vocab: int, target: int) -> int:
    """Largest divisor of ``vocab`` <= target; ``vocab`` itself when the
    only such divisors are degenerately small (< target/8)."""
    if vocab <= target:
        return vocab
    floor = max(1, target // 8)
    for n_chunks in range(2, vocab // floor + 1):
        if vocab % n_chunks == 0 and vocab // n_chunks <= target:
            return vocab // n_chunks
    return vocab


def _lse_pass(logits2d: torch.Tensor, chunk: int, need_total: bool):
    """Per-row logsumexp (and, for smoothing, the per-row logit sum)."""
    tokens, vocab = logits2d.shape
    m = torch.full((tokens,), float("-inf"), dtype=torch.float32,
                   device=logits2d.device)
    s = torch.zeros(tokens, dtype=torch.float32, device=logits2d.device)
    tot = torch.zeros_like(s)
    for start in range(0, vocab, chunk):
        xc = logits2d[:, start:start + chunk].float()
        m_new = torch.maximum(m, xc.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(xc - m_new[:, None]).sum(-1)
        m = m_new
        if need_total:
            tot = tot + xc.sum(dim=-1)
    return m + torch.log(s), tot


class _StreamingCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits2d, labels1d, label_smoothing: float,
                chunk: int):
        tokens, vocab = logits2d.shape
        eps = label_smoothing
        lse, tot = _lse_pass(logits2d, chunk, need_total=bool(eps))
        valid = (labels1d >= 0) & (labels1d < vocab)
        label_logit = logits2d.gather(
            1, labels1d.clamp(0, vocab - 1)[:, None])[:, 0].float()
        nll = torch.where(valid, lse - label_logit, torch.zeros_like(lse))
        if eps:
            nll = (1.0 - eps) * nll + eps * (lse - tot / vocab)
        ctx.save_for_backward(logits2d, labels1d, lse)
        ctx.eps, ctx.chunk = eps, chunk
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        logits2d, labels1d, lse = ctx.saved_tensors
        tokens, vocab = logits2d.shape
        eps = ctx.eps
        scale = (g / tokens).float()
        valid = ((labels1d >= 0) & (labels1d < vocab)).float()
        # d(-sum(target * logp))/dx = softmax * sum(target) - target, where
        # sum(target) per row is (1 - eps) * valid + eps.
        target_mass = (1.0 - eps) * valid + eps if eps else valid
        dlogits = torch.empty_like(logits2d)
        for start in range(0, vocab, ctx.chunk):
            xc = logits2d[:, start:start + ctx.chunk].float()
            p = torch.exp(xc - lse[:, None])
            cols = torch.arange(start, start + xc.shape[1],
                                device=xc.device)
            onehot = (labels1d[:, None] == cols[None, :]).float() \
                * valid[:, None]
            target = (1.0 - eps) * onehot + eps / vocab if eps else onehot
            dlogits[:, start:start + ctx.chunk] = (
                (p * target_mass[:, None] - target) * scale).to(
                    logits2d.dtype)
        return dlogits, None, None, None


def streaming_softmax_cross_entropy(logits: torch.Tensor,
                                    labels: torch.Tensor,
                                    label_smoothing: float = 0.0,
                                    chunk_target: int = 8192
                                    ) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels, streamed over the
    vocab axis so no fp32 logits-sized tensor is materialized; gradients
    reach ``logits`` in the logits' own dtype."""
    vocab = logits.shape[-1]
    logits2d = logits.reshape(-1, vocab)
    labels1d = labels.reshape(-1).long()
    chunk = _pick_chunk(vocab, chunk_target)
    return _StreamingCE.apply(logits2d, labels1d, float(label_smoothing),
                              chunk)
