"""Fused flash attention on an H100: three hand-written CUDA kernels.

The counterpart of ``horovod_tpu/ops/flash_attention.py``.  Same public
functions and semantics: ``flash_attention`` and
``flash_attention_with_lse`` take ``[B, T, H, D]`` (BTHD) tensors, scale
by ``D ** -0.5`` by default, align a causal mask bottom-right (offset
``tk - tq``), reject ``tq > tk`` under causal masking and mixed dtypes,
and return the log-sum-exp as ``[B, H, T]``.

Inside, the layout is ``[B*H, T, D]`` and three CUDA kernels
(``csrc/flash_attention.cu``) do the work, each behind a wrapper:

- ``flash_fwd``     replaces ``_fwd_kernel``      (forward, o and lse);
- ``flash_bwd_dq``  replaces ``_bwd_dq_kernel``   (dq);
- ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``  (dk and dv).

A wrapper given CUDA tensors launches its kernel (bf16 or fp16, head dim
16, 32, 64 or 128; anything else raises ``ValueError``) and adds one to its
``launches`` count; given CPU tensors it runs its plain PyTorch version
(``*_plain``), a dense fp32 computation like the reference's
``_blockwise_jax``.  There is no fallback from one to the other.  The
gradient is a ``torch.autograd.Function`` whose backward runs the two
backward wrappers, with ``delta = rowsum(do * o)`` computed by torch ops
outside the kernels, as the reference computes it outside its own.

Tiles.  All three kernels are warp-specialised for Hopper: TMA loads
into a ring of shared-memory stages and ``wgmma`` products, 64 rows per
consumer warpgroup (blocks of 192 queries at D <= 64 and 128 at D = 128
for the forward and dq, 128 keys for dk/dv).  All mask the ragged
edge, so any sequence length works.  TMA reads q, k, v and do in place,
so their data must start on a 16-byte boundary (a wrapper raises
``ValueError`` on a view at another offset).
The ``block_q``/``block_k``/``block_*_bwd`` arguments are kept for
signature parity with the JAX package and are validated through
``_fit_block``; they do not set the CUDA tiles.  Their defaults (and the
1024 blocks of the TPU benchmark) were tuned for TPU VMEM.
"""
from __future__ import annotations

import torch

from ..common.device import resolve_device
from ._build import LIBRARY

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


# ===========================================================================
# Dense reference (the "dense" attention of the model)
# ===========================================================================
def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, sm_scale: float | None = None,
                  einsum=torch.einsum) -> torch.Tensor:
    """Dense softmax attention. q,k,v: [B, T, H, D] (BTHD).  Scores and
    softmax in fp32; p is cast to v's dtype before the value product.
    ``einsum`` computes the two products (the transformer's remat passes
    one that keeps them)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return einsum("bhqk,bkhd->bqhd", p, v)


# ===========================================================================
# Plain versions of the three kernels ([BH, T, D], dense, fp32 math)
# ===========================================================================
def _scores(q, k, sm_scale, causal):
    """fp32 q.k^T * scale with the bottom-right causal mask (NEG_INF)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * sm_scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(rows + (tk - tq) >= cols, s,
                        torch.full_like(s, NEG_INF))
    return s


def flash_fwd_plain(q, k, v, sm_scale: float, causal: bool):
    """Plain version of the forward kernel: (o [BH,T,D] in q's dtype,
    lse [BH,T] fp32), as ``_blockwise_jax`` computes them."""
    s = _scores(q, k, sm_scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.bmm(p, v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale: float,
                       causal: bool):
    """Plain version of the dq kernel, with its rounding point
    (ds -> k's dtype)."""
    p = torch.exp(_scores(q, k, sm_scale, causal) - lse[..., None])
    dp = torch.bmm(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return torch.bmm(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale: float,
                        causal: bool):
    """Plain version of the dk/dv kernel, with its rounding points
    (p -> do's dtype, ds -> q's dtype)."""
    p = torch.exp(_scores(q, k, sm_scale, causal) - lse[..., None])
    dv = torch.bmm(p.to(do.dtype).float().transpose(1, 2), do.float())
    dp = torch.bmm(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype).float()
    dk = torch.bmm(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def kernel_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a kernel's 16-bit output lies from its plain version's.

    Each element is held to ``2u|ref| + 4u rms(ref row) + u/16 mean|ref|``,
    u the unit roundoff of the output type (2^-8 bf16, 2^-11 fp16), a row
    being the last axis (one query of o and dq, one key of dk and dv).
    The first term is the final rounding of each side; the second is the
    rounding the kernels do inside (p and ds to 16 bits, at another
    running max than the plain version's), which scales with the terms
    the row sums, not with the element.  So a row is checked against its
    own size, and late rows, whose outputs average many keys and are
    small, are held as tightly as early ones.  The third is a floor for
    rows whose true value is 0: the first query of a causal dq sees one
    key, so its ds = p (dp - delta) is fp32 cancellation noise on both
    sides.  ``worst`` is the largest error over its limit (the check
    passes at <= 1)."""
    u = 2.0 ** -8 if ref.dtype == torch.bfloat16 else 2.0 ** -11
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    limit = (2 * u * b.abs() + 4 * u * b.square().mean(-1, keepdim=True).sqrt()
             + u / 16 * b.abs().mean())
    return {"max_abs_err": err.max().item(),
            "worst": (err / limit).nan_to_num(0.0, posinf=float("inf"))
            .max().item(),
            "mean_abs_ref": b.abs().mean().item(),
            "rel_fro_err": (err.norm() / b.norm()).item(),
            "finite": bool(torch.isfinite(a).all()),
            "ok": bool(torch.isfinite(a).all() and (err <= limit).all())}


# ===========================================================================
# Kernel wrappers
# ===========================================================================
def _kernel_inputs(tensors, lse_like=()):
    """Check what the kernels take (q, k, v[, do] as [BH, T, D] of one
    16-bit dtype, lse and delta as [BH, tq] fp32): the kernels index by
    these shapes and read out of bounds on any other.  Return (contiguous
    tensors, dtype code, head dim)."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA flash kernels take bfloat16 or float16, "
                         f"not {q.dtype}")
    if q.dim() != 3 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels take [BH, T, D] with head "
                         f"dim in {HEAD_DIMS}, not {tuple(q.shape)}")
    bh, tq, d = q.shape
    tk = tensors[1].shape[1] if tensors[1].dim() == 3 else -1
    shapes = [(bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d)]
    for x, shape in zip(tensors, shapes):
        if x.dtype != q.dtype or x.device != q.device \
                or tuple(x.shape) != shape:
            raise ValueError("flash kernel inputs must share one dtype and "
                             "device, as q, do [BH, tq, D] and k, v "
                             "[BH, tk, D]")
    for x in lse_like:
        if x.dtype != torch.float32 or x.device != q.device \
                or tuple(x.shape) != (bh, tq):
            raise ValueError("lse and delta must be float32 [BH, tq] on "
                             "q's device")
    tensors = [x.contiguous() for x in tensors]
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("the CUDA flash kernels read q, k, v and do by "
                         "TMA, so their data must start on a 16-byte "
                         "boundary; pass a copy (.clone()) of a view at an "
                         "offset")
    return (tensors, [x.contiguous() for x in lse_like],
            _DTYPE_CODES[q.dtype], d)


def _launch(name: str, device: torch.device, *args) -> None:
    fn = LIBRARY.function(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({LIBRARY.error_string(err)})")


def flash_fwd(q, k, v, sm_scale: float, causal: bool):
    """Forward over [BH, T, D]: returns (o, lse [BH, T] fp32)."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, sm_scale, causal)
    (q, k, v), _, dtype, d = _kernel_inputs((q, k, v))
    bh, tq, _ = q.shape
    tk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    _launch("hvd_flash_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, tq, tk, d,
            dtype, float(sm_scale), int(causal))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale: float, causal: bool):
    """dq over [BH, T, D] from the saved lse and delta = rowsum(do*o)."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, sm_scale, causal)
    (q, k, v, do), (lse, delta), dtype, d = _kernel_inputs(
        (q, k, v, do), (lse, delta))
    bh, tq, _ = q.shape
    dq = torch.empty_like(q)
    _launch("hvd_flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), bh, tq, k.shape[1], d, dtype, float(sm_scale),
            int(causal))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float, causal: bool):
    """(dk, dv) over [BH, T, D] from the saved lse and delta."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, sm_scale,
                                   causal)
    (q, k, v, do), (lse, delta), dtype, d = _kernel_inputs(
        (q, k, v, do), (lse, delta))
    bh, tq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("hvd_flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, tq, k.shape[1], d, dtype,
            float(sm_scale), int(causal))
    flash_bwd_dkv.launches += 1
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
for _wrapper in KERNELS:
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    for wrapper in KERNELS:
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {wrapper.__name__: wrapper.launches for wrapper in KERNELS}


# ===========================================================================
# Autograd
# ===========================================================================
class _FlashAttention(torch.autograd.Function):
    """[BH, T, D] attention returning (o, lse); gradients flow through o
    only (lse is marked non-differentiable)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.sm_scale, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.sm_scale,
                               ctx.causal)
        return dq, dk, dv, None, None


# ===========================================================================
# Public API
# ===========================================================================
def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B*H, T, D] (contiguous)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _split_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def _fit_block(t: int, block: int) -> int:
    """Largest block <= requested that divides the sequence length (the
    JAX package's tiling rule, kept for signature parity)."""
    if block < 1:
        raise ValueError(f"block sizes must be positive (got {block})")
    block = min(block, t)
    while t % block:
        block -= 1
    return block


def _check_dtypes(q, k, v) -> None:
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash attention requires q, k and v to share one dtype "
            f"(got q={q.dtype}, k={k.dtype}, v={v.dtype}); cast the "
            f"inputs to a common dtype first")


def _check_causal_shapes(causal: bool, tq: int, tk: int) -> None:
    if causal and tq > tk:
        raise ValueError(
            f"causal attention requires tq <= tk (got tq={tq}, tk={tk}): "
            "with bottom-right alignment the leading query rows would "
            "attend to nothing")


def _prepare(q, k, v, causal, sm_scale, blocks, device):
    dev = resolve_device(device)
    for x in (q, k, v):
        if x.device.type != dev.type:
            raise ValueError(f"inputs lie on {x.device}, expected {dev}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_dtypes(q, k, v)
    _check_causal_shapes(causal, q.shape[1], k.shape[1])
    for t, block in blocks:
        if block:
            _fit_block(t, block)
    return float(sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: float | None = None,
                    block_q: int = 128, block_k: int = 128,
                    block_q_bwd: int | None = None,
                    block_k_bwd: int | None = None, *,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Fused multi-head attention. q,k,v: [B, T, H, D] (BTHD).
    Differentiable.  Runs the CUDA kernels on the card; ``device="cpu"``
    runs their plain versions on CPU tensors."""
    tq, tk = q.shape[1], k.shape[1]
    sm_scale = _prepare(q, k, v, causal, sm_scale,
                        ((tq, block_q), (tk, block_k), (tq, block_q_bwd),
                         (tk, block_k_bwd)), device)
    b, _, h, _ = q.shape
    out, _ = _FlashAttention.apply(_merge_heads(q), _merge_heads(k),
                                   _merge_heads(v), sm_scale, bool(causal))
    return _split_heads(out, b, h)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             sm_scale: float | None = None,
                             block_q: int = 128, block_k: int = 128, *,
                             device: str | torch.device | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the log-sum-exp
    [B, H, T].  Differentiation flows through the non-lse output only."""
    tq, tk = q.shape[1], k.shape[1]
    sm_scale = _prepare(q, k, v, causal, sm_scale,
                        ((tq, block_q), (tk, block_k)), device)
    b, _, h, _ = q.shape
    out, lse = _FlashAttention.apply(_merge_heads(q), _merge_heads(k),
                                     _merge_heads(v), sm_scale, bool(causal))
    return _split_heads(out, b, h), lse.reshape(b, h, tq)
