"""Serving's elastic rest in the port, on the CPU with gpt_tiny in fp32.

- The serving grow, 2 -> 3 (``tests/torch_statesync_worker.py serve``):
  two incumbents whose parameters are the seed's plus 0.25 serve a first
  wave while a joiner streams those parameters through
  ``join_serving_world`` and enters at a step boundary; the grown world
  serves a second wave.  36 served of 36, none lost or expired, the
  grow recorded 2 -> 3 with goodput before, during and after it, the
  joiner's streamed parameters the incumbents' and its flight events
  ``join-announce``, ``join-ready``, ``join-entered`` in order.
- Disaggregated prefill at 2 ranks (``... disagg``, the reference's
  ``battery_serving_disagg`` under the strict fingerprint): every prompt
  prefilled on rank 1 and streamed, zero fallbacks, all served; rank
  0's streams equal a colocated one-rank paged run's of the port and
  the JAX package's, up to the first token whose logits (the JAX
  model's full forward) have a top-2 margin below 1e-3.
- The kvstream mesh in-process (an image landed, a corrupt chunk
  dropped), the KV block image's round trip through the pools, and the
  loadgen's ``_goodput_phases`` against the reference's.

The serving shrink (a chaos kill, the survivor serving on) is
``tests/test_torch_serving.py::test_two_rank_serving_chaos_kill``.
"""
from __future__ import annotations

import json
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from test_torch_serving import (_assert_streams_agree, _record_streams,
                                _solo_world)
from test_torch_statesync import _run_world, membership_events
from torch_sigterm import restore_sigterm  # noqa: F401
from torch_statesync_worker import (DISAGG_CFG, DISAGG_MAX_NEW,
                                    DISAGG_REQUESTS, disagg_prompts)

HARD_GUARD_SECONDS = 420


@pytest.fixture(autouse=True)
def hard_timeout_guard():
    """A membership deadlock must fail fast, not eat the tier-1
    budget."""
    def _expired(signum, frame):
        raise TimeoutError(f"serving elastic test exceeded the "
                           f"{HARD_GUARD_SECONDS}s hard guard")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(HARD_GUARD_SECONDS)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _record(tmp_path: Path, name: str) -> dict:
    return json.loads((tmp_path / f"{name}.json").read_text())


def test_serving_grow_2_to_3(tmp_path):
    outputs = _run_world("serve", 2, tmp_path)
    assert "serving grow: 36 served across 2->3" in outputs[0], outputs[0]
    assert "streamed params verified (seed + 0.25)" in outputs[0]
    front = _record(tmp_path, "serve.0")
    assert front["served"] == 36
    grow = front["grows"][0]
    assert (grow["from"], grow["to"]) == (2, 3), grow
    phases = front["goodput_phases"]
    assert set(phases) == {"before_rps", "during_rps", "after_rps",
                           "window_s"}
    assert phases["before_rps"] > 0 and phases["after_rps"] > 0, phases
    # Every rank moved to the same generation at the grow.
    gens = {_record(tmp_path, n)["gen"] for n in ("serve.0", "serve.1")}
    assert gens == {1}, gens
    joiner = _record(tmp_path, "serve_joiner.J")
    assert (joiner["rank"], joiner["size"]) == (2, 3)
    assert membership_events(tmp_path, "serve_joiner", "J") == \
        ["join-announce", "join-ready", "join-entered"]
    for r in (0, 1):
        assert membership_events(tmp_path, "serve", r) == \
            ["donate", "grow"]


def _colocated_streams() -> tuple[dict, dict]:
    """The disaggregated battery's requests through a one-rank paged run
    of the port (the seed's weights), and those weights in flax form."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    thvd.init(rank=0, size=1)
    ex = ReplicaExecutor(ServeConfig.from_env(**DISAGG_CFG), device="cpu")
    streams = _record_streams(ex)
    for toks in disagg_prompts(ex.model.cfg.vocab_size):
        ex.stats["offered"] += 1
        ex.queue.submit(toks, DISAGG_MAX_NEW)
    ex.serve_loop(stop_when=lambda: True)
    assert ex.stats["served"] == DISAGG_REQUESTS
    params = convert.params_to_flax(ex.model.state_dict(), ex.model.cfg)
    ex.close()
    return dict(streams), params


def _jax_streams(params) -> dict:
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.serving import ReplicaExecutor, ServeConfig
    import jax.numpy as jnp
    hvd = _solo_world()
    try:
        ex = ReplicaExecutor(ServeConfig.from_env(
            **DISAGG_CFG, model_cfg=jtr.gpt_tiny(dtype=jnp.float32)),
            params=params)
        streams = _record_streams(ex)
        for toks in disagg_prompts(ex.model.cfg.vocab_size):
            ex.stats["offered"] += 1
            ex.queue.submit(toks, DISAGG_MAX_NEW)
        ex.serve_loop(stop_when=lambda: True)
        ex.close()
        return dict(streams)
    finally:
        hvd.shutdown()


def test_disaggregated_prefill_2rank(tmp_path):
    outputs = _run_world("disagg", 2, tmp_path)
    assert "12/12 served via streamed prefill, zero local fallbacks" \
        in outputs[0], outputs[0]
    decode = _record(tmp_path, "disagg.0")
    prefill = _record(tmp_path, "disagg.1")
    assert decode["kv"]["prefill_fallbacks"] == 0
    assert decode["kv"]["prefill_streams"] == 0      # the decode side's
    # KV bytes of a prompt: 2 pools a layer, its blocks of bt tokens.
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    bt = DISAGG_CFG["block_tokens"]
    prompts = {int(k): v for k, v in decode["prompts"].items()}
    want_bytes = sum(2 * cfg.num_layers * -(-len(p) // bt) * bt
                     * cfg.num_heads * cfg.head_dim * 4
                     for p in prompts.values())
    assert prefill["sent_bytes"] == want_bytes
    got = {int(k): v for k, v in decode["streams"].items()}
    colocated, params = _colocated_streams()
    assert sorted(got) == sorted(colocated) == list(range(DISAGG_REQUESTS))
    _assert_streams_agree(got, colocated, prompts, params,
                          "disaggregated vs colocated")
    _assert_streams_agree(got, _jax_streams(params), prompts, params,
                          "disaggregated vs the JAX package")


def test_kvstream_mesh_lands_images_and_drops_corrupt_ones():
    """Two ranks of a kvstream mesh in threads: rank 1 (prefill) streams
    an image in three chunks to rank 0, which lands it whole; a chunk
    whose CRC fails drops its transfer."""
    from horovod_tpu_torch.runner.network import (RendezvousClient,
                                                  RendezvousServer)
    from horovod_tpu_torch.serving import kvstream
    srv = RendezvousServer()
    port = srv.start()
    meshes = [None, None]

    def form(rank):
        kv = RendezvousClient("127.0.0.1", port, 20.0)
        meshes[rank] = kvstream.KVStreamMesh(
            kv, kvstream.kvstream_scope("u", 0), rank, 2, [1],
            chunk_bytes=100)
    threads = [threading.Thread(target=form, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    decode, prefill = meshes
    try:
        image = torch.arange(60, dtype=torch.float32).reshape(3, 20)
        prefill.send_image(7, [0], image.view(torch.uint8).reshape(-1)
                           .numpy(), first=5, plen=9, cursor=9,
                           shape=(3, 20), dtype="float32")
        deadline = time.monotonic() + 10
        while decode.ready_rids() != [7] and time.monotonic() < deadline:
            time.sleep(0.01)
        img = decode.pop_ready(7)
        assert img is not None and decode.pop_ready(7) is None
        assert (img.first, img.plen, img.cursor, img.shape, img.dtype) \
            == (5, 9, 9, (3, 20), "float32")
        got = torch.frombuffer(img.data, dtype=torch.uint8).view(
            torch.float32).reshape(img.shape)
        assert torch.equal(got, image)
        # A corrupt chunk: the transfer is dropped, never landed.
        prefill.mesh.send(0, kvstream.pack_kv_frame(
            kvstream.KVS_DATA, {"rid": 8, "o": 0, "n": 4, "crc": 1,
                                "total": 4}, b"\x00\x00\x00\x01"))
        prefill.mesh.send(0, kvstream.pack_kv_frame(
            kvstream.KVS_DONE, {"rid": 8, "total": 4, "first": 1,
                                "plen": 1, "cursor": 1, "shape": [1],
                                "dtype": "float32"}))
        time.sleep(0.3)
        assert decode.pop_ready(8) is None
    finally:
        for m in meshes:
            if m is not None:
                m.close()
        srv.stop()


def test_kv_block_image_round_trips_through_the_pools():
    """``_extract_blocks`` of one paged executor inserted into another's
    pool by ``_insert_blocks`` at other block ids: the rows are equal,
    and the image is the port's paged layout, ``[2L, nblk, bt, H, D]``
    (each layer's key pool, then its value pool)."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    thvd.init(rank=0, size=1)
    cfg = ServeConfig.from_env(**DISAGG_CFG)
    src = ReplicaExecutor(cfg, device="cpu")
    dst = ReplicaExecutor(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.inference_mode():        # the pools are inference tensors
        for leaf in src._cache_pool_leaves():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    image = src._extract_blocks(3)
    mc = src.model.cfg
    assert tuple(image.shape) == (2 * mc.num_layers, 3, cfg.block_tokens,
                                  mc.num_heads, mc.head_dim)
    raw = image.view(torch.uint8).reshape(-1).numpy().tobytes()
    back = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        torch.float32).reshape(image.shape)
    dst._insert_blocks([5, 1, 6], back)
    for i, (a, b) in enumerate(zip(src._cache_pool_leaves(),
                                   dst._cache_pool_leaves())):
        assert torch.equal(b[[5, 1, 6]], a[:3]), i
        assert torch.equal(image[i], a[:3])
    src.close()
    dst.close()


def test_goodput_phases_match_reference():
    from types import SimpleNamespace

    from horovod_tpu.serving.loadgen import _goodput_phases as j_phases
    from horovod_tpu_torch.serving.loadgen import _goodput_phases
    done = [100.0 + 0.1 * i for i in range(40)]
    for grows in ([], [{"at": 102.0, "window_s": 0.5}],
                  [{"at": 101.0}, {"at": 103.0, "window_s": 1.0}]):
        ex = SimpleNamespace(stats={"grows": grows, "completed_at": done})
        assert _goodput_phases(ex, 4.0) == j_phases(ex, 4.0)
    assert _goodput_phases(SimpleNamespace(
        stats={"grows": [], "completed_at": done}), 4.0) is None
    phases = _goodput_phases(SimpleNamespace(stats={
        "grows": [{"at": 102.0, "window_s": 0.5}], "completed_at": done}),
        4.0)
    assert phases["before_rps"] == pytest.approx(15 / 1.5)
    assert np.isfinite(list(phases.values())).all()
