"""KV-cache decoding of the port against the flax model, on the CPU.

The same weights (``convert.params_from_flax``) and the same tokens, made
with numpy from a seed, go through the reference's ``prefill``,
``decode_step``, ``paged_apply`` and ``paged_copy_block`` and through the
port's.  Tolerances, fp32 on gpt_tiny: logits within 1e-4, live cache rows
within 1e-5, cursors equal.  One case in bf16 (dense prefill and decode):
logits within 2 bf16 ulps at the logits' scale.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGITS_TOL, CACHE_TOL = 1e-4, 1e-5


def _models(dtype="float32", **overrides):
    jcfg = jtr.gpt_tiny(dtype=_JNP[dtype], decode=True, **overrides)
    tcfg = ttr.gpt_tiny(dtype=_TORCH[dtype], decode=True, **overrides)
    params = jtr.TransformerLM(jtr.gpt_tiny(dtype=_JNP[dtype])).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = ttr.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, tcfg))
    return jtr.TransformerLM(jcfg), {"params": params}, model, tcfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(ref: np.ndarray, dtype: str) -> float:
    """1e-4 in fp32; in bf16, 2 ulps at the logits' scale (the largest
    magnitude), an ulp being 2^-7 of the power of two below it."""
    if dtype == "float32":
        return LOGITS_TOL
    scale = float(np.abs(ref).max())
    return 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _assert_dense_cache(jcache, tcache, cfg, live):
    """Index equal; K/V equal (1e-5) at every row's live positions."""
    ref = convert.cache_from_flax(jcache, cfg)
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(tcache.index[layer].numpy(),
                                      ref.index[layer].numpy())
        for b, n in enumerate(live):
            for got, want in ((tcache.key, ref.key),
                              (tcache.value, ref.value)):
                np.testing.assert_allclose(
                    _np(got[layer][b, :n]), _np(want[layer][b, :n]),
                    atol=CACHE_TOL, rtol=0, err_msg=f"layer {layer} row {b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_flax(dtype):
    """Right-padded prompts with ``lengths``, then 8 decode steps."""
    jmodel, variables, tmodel, cfg = _models(dtype)
    rng = np.random.default_rng(0)
    lengths = np.array([16, 9, 5], np.int32)
    tokens = rng.integers(0, 256, (3, 16)).astype(np.int32)
    jlogits, jcache = jtr.prefill(jmodel, variables, jnp.asarray(tokens),
                                  lengths=jnp.asarray(lengths))
    tlogits, tcache = ttr.prefill(tmodel, tokens, lengths=lengths)
    assert tlogits.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_np(tlogits), _np(jlogits),
                               atol=_tol(_np(jlogits), dtype), rtol=0)
    if dtype == "float32":
        _assert_dense_cache(jcache, tcache, cfg, lengths)
    live = lengths.copy()
    for _ in range(8):
        step = rng.integers(0, 256, (3, 1)).astype(np.int32)
        jlogits, jcache = jtr.decode_step(jmodel, variables, jcache,
                                          jnp.asarray(step))
        tlogits, tcache = ttr.decode_step(tmodel, tcache, step)
        assert tuple(tlogits.shape) == (3, 1, 256)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits),
                                   atol=_tol(_np(jlogits), dtype), rtol=0)
        live += 1
    if dtype == "float32":
        _assert_dense_cache(jcache, tcache, cfg, live)


def test_write_past_the_end_clamps_like_dynamic_update_slice():
    """A cursor past S - t writes at S - t, as ``dynamic_update_slice``
    clamps its start: rows run past the end (a free serving slot does)
    without raising, and the whole cache stays equal to the reference's.
    """
    jmodel, variables, tmodel, cfg = _models(max_seq_len=12)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (2, 8)).astype(np.int32)
    _, jcache = jtr.prefill(jmodel, variables, jnp.asarray(tokens))
    _, tcache = ttr.prefill(tmodel, tokens)
    for _ in range(7):                  # cursor 8 -> 15, S = 12
        step = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jlogits, jcache = jtr.decode_step(jmodel, variables, jcache,
                                          jnp.asarray(step))
        tlogits, tcache = ttr.decode_step(tmodel, tcache, step)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits),
                                   atol=LOGITS_TOL, rtol=0)
    assert tcache.index[0].tolist() == [15, 15]
    _assert_dense_cache(jcache, tcache, cfg, [12, 12])
    # Two tokens at cursor S - 1 land at S - 2 and S - 1.
    two = rng.integers(0, 256, (2, 2)).astype(np.int32)
    jcache = jtr._with_cache_index(jcache, 11)
    tcache = ttr._with_cache_index(tcache, 11)
    jlogits, jcache = jtr.decode_step(jmodel, variables, jcache,
                                      jnp.asarray(two))
    tlogits, tcache = ttr.decode_step(tmodel, tcache, two)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=LOGITS_TOL,
                               rtol=0)
    _assert_dense_cache(jcache, tcache, cfg, [12, 12])


# --- the paged cache ---------------------------------------------------------
POOL, BT, M = 12, 4, 6
SINK = POOL


def _paged_models():
    return _models(paged=True, kv_pool_blocks=POOL, kv_block_tokens=BT)


def _paged_call(jmodel, variables, tmodel, jcache, tcache, tokens, tables,
                cursors, lengths=None):
    args = [np.asarray(a, np.int32) for a in (tokens, tables, cursors)]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else np.asarray(lengths, np.int32)
    jlogits, jcache = jtr.paged_apply(jmodel, variables, jcache,
                                      *(jnp.asarray(a) for a in args),
                                      lengths=jl)
    tlogits, tcache = ttr.paged_apply(tmodel, tcache, *args, lengths=tl)
    return jlogits, jcache, tlogits, tcache


def _assert_pools(jcache, tcache, cfg):
    """Every real block equal (1e-5); the sink row is garbage both sides
    write and nothing reads."""
    ref = convert.cache_from_flax(jcache, cfg)
    for layer in range(cfg.num_layers):
        for got, want in ((tcache.key_pool, ref.key_pool),
                          (tcache.value_pool, ref.value_pool)):
            np.testing.assert_allclose(_np(got[layer][:SINK]),
                                       _np(want[layer][:SINK]),
                                       atol=CACHE_TOL, rtol=0)


def test_paged_apply_and_copy_block_match_flax():
    """Two prompts share their first two blocks; a padded prefill writes
    into the sink; a free row decodes into the sink; a copy-on-write
    repoints one row at a private copy of a shared block."""
    jmodel, variables, tmodel, cfg = _paged_models()
    tcache = ttr.PagedKVCache.zeros(cfg, torch.device("cpu"))
    jcache = jax.tree_util.tree_map(
        jnp.asarray,
        convert.cache_to_flax(tcache, cfg))
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 256, 8)
    a_tail, b_tail = rng.integers(0, 256, 2), rng.integers(0, 256, 5)
    tables = np.full((3, M), SINK, np.int32)
    tables[0, :5] = [0, 1, 2, 3, 6]
    tables[1, :] = [0, 1, 4, 5, 7, 8]

    # Row 0's prompt (10 tokens) padded to 16: positions 10-15 go to sink.
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :10] = np.concatenate([shared, a_tail])
    jl, jcache, tl, tcache = _paged_call(
        jmodel, variables, tmodel, jcache, tcache, prompt, tables[:1],
        [0], lengths=[10])
    np.testing.assert_allclose(_np(tl)[0, :10], _np(jl)[0, :10],
                               atol=LOGITS_TOL, rtol=0)
    # Row 1 resumes past the shared prefix (blocks 0 and 1) at cursor 8.
    rest = np.zeros((1, 8), np.int32)
    rest[0, :5] = b_tail
    jl, jcache, tl, tcache = _paged_call(
        jmodel, variables, tmodel, jcache, tcache, rest, tables[1:2], [8],
        lengths=[5])
    np.testing.assert_allclose(_np(tl)[0, :5], _np(jl)[0, :5],
                               atol=LOGITS_TOL, rtol=0)
    _assert_pools(jcache, tcache, cfg)

    # Decode the batch: rows 0 and 1 live, row 2 free (all sink, cursor 0).
    cursors = np.array([10, 13, 0], np.int32)
    for step in range(6):
        if step == 3:
            # Copy-on-write of shared block 1 into 9 for row 1.
            jcache = jtr.paged_copy_block(jcache, jnp.int32(1),
                                          jnp.int32(9))
            tcache = ttr.paged_copy_block(tcache, 1, 9)
            tables[1, 1] = 9
        toks = rng.integers(0, 256, (3, 1)).astype(np.int32)
        jl, jcache, tl, tcache = _paged_call(
            jmodel, variables, tmodel, jcache, tcache, toks, tables,
            cursors)
        np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2],
                                   atol=LOGITS_TOL, rtol=0)
        cursors[:2] += 1
    _assert_pools(jcache, tcache, cfg)
    # Row 1 wrote nothing into logical block 1 after the copy.
    for pool in (*tcache.key_pool, *tcache.value_pool):
        assert torch.equal(pool[9], pool[1])


def test_paged_decode_equals_dense_decode():
    """The same admitted sequence through the paged and the dense cache
    gives the same logits (the reference's own parity, on the port)."""
    _, _, dense, _ = _models()
    _, _, paged, cfg = _paged_models()
    paged.load_state_dict(dense.state_dict())
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (1, 11)).astype(np.int32)
    dl, dcache = ttr.prefill(dense, prompt)
    pcache = ttr.PagedKVCache.zeros(cfg, torch.device("cpu"))
    table = np.array([[3, 0, 5, 1, SINK, SINK]], np.int32)
    pl, pcache = ttr.paged_apply(paged, pcache, prompt, table, [0])
    torch.testing.assert_close(pl, dl, atol=1e-5, rtol=0)
    for i in range(5):
        tok = rng.integers(0, 256, (1, 1)).astype(np.int32)
        dl, dcache = ttr.decode_step(dense, dcache, tok)
        pl, pcache = ttr.paged_apply(paged, pcache, tok, table, [11 + i])
        torch.testing.assert_close(pl, dl, atol=1e-5, rtol=0)


def test_cache_round_trip_through_flax():
    _, _, model, cfg = _models()
    rng = np.random.default_rng(4)
    _, cache = ttr.prefill(model, rng.integers(0, 256, (2, 8)), lengths=5)
    back = convert.cache_from_flax(convert.cache_to_flax(cache, cfg), cfg)
    for got, want in zip(back.key + back.value + back.index,
                         cache.key + cache.value + cache.index):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_decode_needs_its_cache_and_refuses_sequence_parallel():
    _, _, model, cfg = _models()
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="KVCache"):
        model(tokens)
    with pytest.raises(ValueError, match="decode=True"):
        ttr.TransformerLM(ttr.gpt_tiny(), device="cpu")(
            tokens, cache=ttr.KVCache.zeros(cfg, 1, torch.device("cpu")))
    with pytest.raises(ValueError, match="sequence-parallel"):
        ttr.TransformerLM(ttr.gpt_tiny(decode=True, attention="ring"),
                          device="cpu")
    _, _, paged, pcfg = _paged_models()
    with pytest.raises(ValueError, match="block_tables"):
        paged(tokens, cache=ttr.PagedKVCache.zeros(pcfg,
                                                   torch.device("cpu")))
    with pytest.raises(ValueError, match="dense path"):
        ttr.prefill(paged, tokens)
