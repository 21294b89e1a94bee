"""The port's CUDA kernels on the card: each against its plain version at
small and ragged shapes, every head dim and both 16-bit types, and the
checks the wrappers make on CUDA tensors.

These tests need an NVIDIA card with nvcc (sm_90a); elsewhere they skip.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports torch and the port only, so that it runs where JAX is
not installed.
"""
from __future__ import annotations

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA C++ with "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


SHAPES = [  # (bh, tq, tk, d, causal, dtype)
    (3, 64, 64, 64, True, torch.bfloat16),
    (2, 100, 160, 64, False, torch.bfloat16),
    (2, 100, 160, 64, True, torch.bfloat16),
    (2, 77, 77, 16, True, torch.float16),
    (2, 130, 200, 32, True, torch.bfloat16),
    (2, 96, 96, 128, True, torch.float16),
    (2, 96, 150, 128, False, torch.bfloat16),
    # One query (a tile that is all edge) over two keys; with one key
    # the softmax is constant, so dq, dk are 0 and only noise is left.
    (1, 1, 2, 64, True, torch.bfloat16),
    # Many ring stages under the causal skip, with a ragged last tile.
    (2, 1000, 1000, 64, True, torch.bfloat16),
    # Two TMA boxes a row (D = 128), tq < tk, ragged in both.
    (2, 300, 777, 128, False, torch.float16),
    # lse rows of 77 floats: a stride TMA could not take.
    (2, 77, 77, 32, True, torch.bfloat16),
    # One head shorter than every tile.
    (1, 50, 90, 64, True, torch.bfloat16),
    # Causal tq < tk with an offset (256) that is not a multiple of the
    # dq kernel's block (192 queries), so its diagonal crosses key tiles.
    (2, 200, 456, 64, True, torch.bfloat16),
    # More heads than one head group (16), the last group part-filled.
    (17, 256, 256, 64, True, torch.bfloat16),
    # D = 16 (32-byte swizzle) over many ring stages, ragged.
    (3, 700, 700, 16, True, torch.float16),
]


@pytest.mark.parametrize("bh,tq,tk,d,causal,dtype", SHAPES)
def test_kernels_match_plain_versions(bh, tq, tk, d, causal, dtype):
    gen = torch.Generator(device="cuda").manual_seed(bh * tq + d)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", dtype=dtype,
                               generator=gen) for t in (tq, tk, tk, tq))
    scale = d ** -0.5
    before = fa.launch_counts()
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                            causal)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    for name, a, b in (("o", o, o_ref), ("dq", dq, dq_ref),
                       ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert a.dtype == dtype and a.shape == b.shape, name
        # Each element within 2u|ref| + 4u rms(ref row) + u/16 mean|ref|,
        # u the unit roundoff of the 16-bit type (fa.kernel_error).
        report = fa.kernel_error(a, b)
        assert report["ok"], (name, report)
    # lse is fp32 on both sides; the kernel's exp is ex2.approx.
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_dq_is_deterministic():
    # Each block owns its dq rows and adds its key tiles in one order: no
    # atomics, so two calls agree bit for bit.
    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, tq, tk, d = 6, 640, 896, 64
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for t in (tq, tk, tk, tq))
    o, lse = fa.flash_fwd(q, k, v, d ** -0.5, True)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_bwd_dq(q, k, v, do, lse, delta, d ** -0.5, True)
    second = fa.flash_bwd_dq(q, k, v, do, lse, delta, d ** -0.5, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_autograd_matches_dense_reference():
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 64, device="cuda",
                           dtype=torch.bfloat16, generator=gen)
               .requires_grad_() for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    q2, k2, v2 = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref = fa.mha_reference(q2, k2, v2, causal=True)
    ref_grads = torch.autograd.grad(ref.square().sum(), (q2, k2, v2))
    # bf16 inputs and outputs against an fp32 reference: a few percent
    # of each tensor's largest value.
    assert (out.float() - ref).abs().max().item() \
        <= 0.02 * ref.abs().max().item()
    for g, r in zip(grads, ref_grads):
        assert (g.float() - r).abs().max().item() \
            <= 0.05 * r.abs().max().item()


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 48),
                                     (torch.bfloat16, 256)])
def test_unsupported_inputs_raise(dtype, d):
    q = torch.zeros(1, 16, d, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="CUDA flash kernels"):
        fa.flash_fwd(q, q, q, 1.0, False)


def test_mismatched_shapes_raise():
    q = torch.zeros(2, 16, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(2, 32, 64, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(2, 16, device="cuda")
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, k, q, 1.0, False)          # v is not [BH, tk, D]
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, k[:1], k[:1], 1.0, False)  # another BH
    with pytest.raises(ValueError, match=r"\[BH, tq\]"):
        fa.flash_bwd_dq(q, k, k, q, lse[:, :8], lse, 1.0, False)
    fa.flash_bwd_dq(q, k, k, q, lse, lse, 1.0, False)


def test_misaligned_inputs_raise():
    # A contiguous view 8 bytes into its storage: TMA and the 16-byte
    # loads need 16-byte aligned bases, so the wrappers refuse it.
    flat = torch.zeros(2 * 64 * 64 + 4, device="cuda", dtype=torch.bfloat16)
    q = flat[4:].view(2, 64, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 8
    lse = torch.zeros(2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_fwd(q, q, q, 1.0, False)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_bwd_dkv(q, q, q, q, lse, lse, 1.0, False)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse, 1.0, False)


def test_gpt_tiny_serves_dense_and_paged_alike():
    """The serving replica on the card: gpt_tiny in fp32, the same
    requests through the dense and the paged cache give the same token
    streams, and no flash kernel runs on the serving path."""
    import random

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig

    rng = random.Random(7)
    prompts = [[rng.randrange(2, 256) for _ in range(rng.randint(2, 40))]
               for _ in range(4)]
    fa.reset_launch_counts()
    streams = {}
    hvd.init(rank=0, size=1)           # the executor's world is hvd's
    for paged in (False, True):
        ex = ReplicaExecutor(ServeConfig(max_batch=2, token_budget=64,
                                         max_seq=64, slo_ms=60000.0,
                                         block_tokens=8, paged=paged))
        got = {}
        collect = ex._collect_completions

        def record(ex=ex, got=got, collect=collect):
            for s in ex.slots:
                if s is not None and s.remaining == 0:
                    got[s.rid] = list(s.generated)
            collect()
        ex._collect_completions = record
        for i in range(12):
            ex.queue.submit(prompts[i % 4], 6)
        ex.serve_loop(stop_when=lambda: True)
        assert ex.stats["served"] == 12
        if paged:
            kv = ex.kv_stats()
            assert kv["active"] == 0 and kv["prefix_hits"] > 0, kv
        streams[paged] = got
        ex.close()
    hvd.shutdown()
    assert streams[False] == streams[True]
    assert sum(fa.launch_counts().values()) == 0


@pytest.fixture
def fp32_convs():
    """cuDNN convolutions in full fp32 for the comparisons below."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def _small_resnets(stem="conv7"):
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    cpu = ResNet((1, 1, 1), BottleneckBlock, num_filters=8, num_classes=10,
                 dtype=torch.float32, stem=stem, device="cpu", seed=3)
    card = ResNet((1, 1, 1), BottleneckBlock, num_filters=8, num_classes=10,
                  dtype=torch.float32, stem=stem, seed=4)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("train", [True, False])
def test_small_resnet_on_card_matches_cpu(fp32_convs, train):
    """fp32 ResNet with the same weights on the card and on the CPU:
    logits within 1e-4 of max|ref|, running statistics within 1e-5."""
    cpu, card = _small_resnets()
    x = torch.randn(4, 33, 33, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = cpu(x, train)
        got = card(x.cuda(), train).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    stats = dict(card.named_buffers())
    for name, ref in cpu.named_buffers():
        assert (stats[name].cpu() - ref).abs().max() <= 1e-5, name


def test_space_to_depth_stem_matches_conv7_on_card(fp32_convs):
    from horovod_tpu_torch.models.resnet import fold_conv7_stem_weights
    _, conv7 = _small_resnets()
    _, s2d = _small_resnets("space_to_depth")
    state = conv7.state_dict()
    state["conv_init.weight"] = fold_conv7_stem_weights(
        state["conv_init.weight"])
    s2d.load_state_dict(state)
    x = torch.randn(2, 32, 32, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    with torch.no_grad():
        want, got = conv7(x), s2d(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_cnn_activations_are_channels_last():
    """Every conv and BatchNorm output on the card is channels_last, so
    cuDNN needs no layout transposes; the conv weights are too."""
    from horovod_tpu_torch.models import layers
    from horovod_tpu_torch.models.inception import InceptionA
    _, model = _small_resnets()
    block = InceptionA(16, 8, device="cuda")
    seen = []

    def hook(module, args, out):
        seen.append((type(module).__name__, out.is_contiguous(
            memory_format=torch.channels_last)))
    for m in list(model.modules()) + list(block.modules()):
        if isinstance(m, layers.Conv):
            assert m.weight.is_contiguous(memory_format=torch.channels_last)
        if isinstance(m, (layers.Conv, layers.BatchNorm)):
            m.register_forward_hook(hook)
    model(torch.randn(2, 32, 32, 3, device="cuda"), train=True)
    x = torch.randn(2, 5, 5, 16, device="cuda").permute(0, 3, 1, 2)
    assert block(x, train=True).is_contiguous(
        memory_format=torch.channels_last)
    assert seen and all(ok for _, ok in seen), seen


@pytest.mark.parametrize("codec", ["int8", "uint4"])
@pytest.mark.parametrize("block", [2, 16, 256])
def test_codec_on_card_matches_cpu_bitwise(codec, block):
    """quantize_rows and dequantize_rows are correctly rounded fp32 ops
    (min, max, subtract, divide, round half to even, multiply, add), so
    the card gives the CPU's bytes."""
    from horovod_tpu_torch.compress import CompressionCodec
    from horovod_tpu_torch.compress import ops
    c = CompressionCodec[codec.upper()]
    gen = torch.Generator().manual_seed(block)
    x = torch.randn(3, block * 333, generator=gen) * 3
    x[1, :block] = 0.7                      # a constant block
    host = ops.quantize_rows(x, c, block)
    card = ops.quantize_rows(x.cuda(), c, block)
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(ops.dequantize_rows(*card, c, block).cpu(),
                       ops.dequantize_rows(*host, c, block))


def test_quantized_allreduce_on_card_matches_cpu():
    """One rank without a process group: quantize, reduce, requantize,
    dequantize, the same on the card as on the CPU."""
    from horovod_tpu_torch.compress import CompressionCodec
    from horovod_tpu_torch.compress import ops
    x = torch.randn(100_003, generator=torch.Generator().manual_seed(1))
    r = torch.randn(100_003, generator=torch.Generator().manual_seed(2))
    for c in (CompressionCodec.INT8, CompressionCodec.UINT4):
        host = ops.quantized_allreduce(x, None, "average", c, 64, residual=r)
        card = ops.quantized_allreduce(x.cuda(), None, "average", c, 64,
                                       residual=r.cuda())
        for a, b in zip(card, host):
            assert torch.equal(a.cpu(), b)
