"""perfscope — the algorithm-aware roofline and FLOP model: the port's own
copy of ``horovod_tpu/telemetry/perfmodel.py``.

Pure functions: arithmetic over the collective-algorithm vocabulary
(``common/topology.ALGO_NAMES``), the snapshot schema
(``telemetry/registry.py``) and the port's models.  Three layers read it:

- **core dispatch** (``core._observe_collective``) folds each executed
  response's latency into a bus-bandwidth observation —
  ``busbw = algbw x op_factor(N)``, the nccl-tests convention — and the
  roofline-relative efficiency gauge;
- **the perf CLI** (``python -m horovod_tpu_torch.telemetry.perf``) merges
  rank dumps into the PERF.json ledger: per (plane, op, codec, algo,
  size-bucket) busbw against the peak link bandwidth
  (``HOROVOD_PERF_PEAK_MBPS``, else the best cell of the window),
  discounted by each algorithm's wire-byte overhead over the ring;
- **MFU**: the FLOPs of the port's models (``TransformerLM`` in training
  and decode, the CNNs) against the card's dense bf16 peak.  The
  ``Trainer`` and the serving replica set the gauges.

Three counts differ from the reference's on purpose: the Transformer's
parameter count holds its own LM head (the model's ``lm_head`` is not
tied to the embedding), an MoE expert holds two matrices (``wi``,
``wo``), as ``models/moe.py`` has them, and the FLOPs of an MoE layer
count the parameters a token passes through (the router and the one
expert of top-1 routing), not every expert it holds.

Reference formulas (S = payload bytes, N = ranks):

=============  =========================  ====================
algo           critical-path wire bytes   hops
=============  =========================  ====================
ring           2(N-1)/N * S               2(N-1)
tree           2*ceil(log2 N) * S         2*ceil(log2 N)
rhd            2(N-1)/N * S               2*ceil(log2 N)
torus (RxC)    2(N-1)/N * S               2(C-1) + 2(R-1)
hierarchical   sum_i 2(l_i-1)/l_i * S_i   sum_i 2(l_i-1)
=============  =========================  ====================

(the two-phase torus telescopes to exactly 2(N-1)/N * S; its win is the
hop count.  N-level hierarchical: level i moves 2(l_i-1)/l_i of the shard
S_i = S / prod(levels[:i]) left by the inner levels.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

# ---------------------------------------------------------------------------
# Size buckets: power-of-16 boundaries from 4 KiB keep the label set small
# while separating the latency-bound, crossover and bandwidth-bound
# regimes the algorithm selection distinguishes.
# ---------------------------------------------------------------------------
_BUCKET_BOUNDS = ((4 << 10, "4KiB"), (64 << 10, "64KiB"),
                  (1 << 20, "1MiB"), (16 << 20, "16MiB"),
                  (256 << 20, "256MiB"))
SIZE_BUCKETS = tuple(label for _, label in _BUCKET_BOUNDS) + ("huge",)


def size_bucket(nbytes: float) -> str:
    """Bucket label of a payload size (upper-bound buckets)."""
    for bound, label in _BUCKET_BOUNDS:
        if nbytes <= bound:
            return label
    return "huge"


# ---------------------------------------------------------------------------
# Peak dense bf16 FLOP/s of one card, by a lower-case substring of
# torch.cuda.get_device_name(); first match wins.  The dense bf16
# tensor-core rates of the NVIDIA H100 data sheet: the PCIe card, then the
# SXM card by its own name ("NVIDIA H100 80GB HBM3").  Other H100 kinds
# (the NVL, say) have other rates and match no row.
# ---------------------------------------------------------------------------
PEAK_FLOPS_TABLE = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989e12),
)

# Unknown kinds (the CPU) get a nominal 1 TFLOP/s, so that the MFU
# trajectory is still populated and comparable from run to run; only a
# card of the table reports an absolute utilization.
NOMINAL_PEAK_FLOPS = 1e12


def table_peak_flops(device_kind: str) -> float | None:
    """The table's peak for a device kind, None when no row matches."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_FLOPS_TABLE:
        if key in kind:
            return peak
    return None


def peak_flops(device_kind: str) -> float:
    """Peak dense FLOP/s of one card of ``device_kind``: the bf16 rate,
    whatever dtype a step computes in (as the reference's table).
    ``HOROVOD_PERF_PEAK_FLOPS`` overrides the table; an unknown kind gets
    NOMINAL_PEAK_FLOPS."""
    from ..common import config
    knob = float(config.PERF_PEAK_FLOPS.get())
    if knob > 0.0:
        return knob
    peak = table_peak_flops(device_kind)
    return NOMINAL_PEAK_FLOPS if peak is None else peak


def device_kind(device) -> str:
    """The kind the peak table is read by: the card's name, or "cpu"."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


# ---------------------------------------------------------------------------
# Wire cost per algorithm
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WireCost:
    """Critical-path cost of one collective under one algorithm."""
    wire_bytes: float     # bytes crossing any single rank's links
    hops: int             # serialized link traversals (latency terms)


def _hierarchical_cost(nbytes: float, levels: list[int]) -> WireCost:
    wire = 0.0
    hops = 0
    shard = float(nbytes)
    for size in levels:
        if size <= 1:
            continue
        wire += 2.0 * (size - 1) / size * shard
        hops += 2 * (size - 1)
        shard /= size
    return WireCost(wire, hops)


def wire_cost(algo: str, nbytes: float, topology: Any) -> WireCost:
    """Expected critical-path (wire bytes, hops) of one allreduce of
    ``nbytes`` under ``algo`` on ``topology`` (``common/topology.Topology``
    or anything with .size/.rows/.cols/.levels())."""
    n = max(int(getattr(topology, "size", 1)), 1)
    if n <= 1:
        return WireCost(0.0, 0)
    log2n = int(math.ceil(math.log2(n)))
    ring_bytes = 2.0 * (n - 1) / n * nbytes
    if algo == "tree":
        return WireCost(2.0 * log2n * nbytes, 2 * log2n)
    if algo == "rhd":
        return WireCost(ring_bytes, 2 * log2n)
    if algo == "torus" and getattr(topology, "kind", "") == "torus":
        rows = max(int(getattr(topology, "rows", 1)), 1)
        cols = max(int(getattr(topology, "cols", 1)), 1)
        return WireCost(ring_bytes, 2 * (cols - 1) + 2 * (rows - 1))
    if algo in ("hier", "hierarchical"):
        levels = topology.levels() if hasattr(topology, "levels") else [n]
        return _hierarchical_cost(nbytes, levels)
    # ring, auto, torus on a flat layout, and unknown labels: the
    # bandwidth-optimal ring schedule is the reference cost.
    return WireCost(ring_bytes, 2 * (n - 1))


def algo_overhead(algo: str, topology: Any) -> float:
    """Wire-byte overhead of ``algo`` over the bandwidth-optimal ring:
    >= 1.0, the roofline's divisor."""
    ring = wire_cost("ring", 1.0, topology).wire_bytes
    mine = wire_cost(algo, 1.0, topology).wire_bytes
    if ring <= 0.0 or mine <= 0.0:
        return 1.0
    return max(mine / ring, 1.0)


# ---------------------------------------------------------------------------
# Bus bandwidth (nccl-tests convention)
# ---------------------------------------------------------------------------
def busbw_factor(op: str, n: int) -> float:
    """busbw = algbw x factor: the multiplier that makes measured
    bandwidth comparable across ops and world sizes (the nccl-tests
    convention)."""
    if n <= 1:
        return 1.0
    if op in ("allreduce", "adasum"):
        return 2.0 * (n - 1) / n
    if op in ("allgather", "reducescatter", "alltoall"):
        return float(n - 1) / n
    return 1.0     # broadcast / barrier-ish ops move S end to end


def busbw_mbps(op: str, nbytes: float, latency_ms: float, n: int) -> float:
    """Measured bus bandwidth in MB/s of one executed collective."""
    if latency_ms <= 0.0 or nbytes <= 0.0:
        return 0.0
    algbw = nbytes / (latency_ms / 1e3)          # bytes/s
    return algbw * busbw_factor(op, n) / 1e6


def expected_ms(algo: str, nbytes: float, topology: Any,
                peak_mbps: float, hop_us: float = 25.0) -> float:
    """Roofline time of one allreduce: critical-path wire bytes at peak
    link bandwidth plus the serialized hop latency."""
    if peak_mbps <= 0.0:
        return 0.0
    cost = wire_cost(algo, nbytes, topology)
    return cost.wire_bytes / (peak_mbps * 1e6) * 1e3 \
        + cost.hops * hop_us / 1e3


# ---------------------------------------------------------------------------
# FLOPs — TransformerLM
# ---------------------------------------------------------------------------
def param_count(module: Any) -> int:
    """Parameter count of a module: the ``numel`` sum of its
    parameters."""
    return sum(int(p.numel()) for p in module.parameters())


def transformer_param_count(cfg: Any) -> int:
    """Parameter count of a TransformerLM config, as the model holds it:
    the embedding, per block the attention, the MLP (gate, up, down) or
    the MoE layer (router and two matrices an expert) and two norms, the
    final norm and the LM head."""
    d, L = cfg.d_model, cfg.num_layers
    attn = 4 * d * d
    if getattr(cfg, "moe_experts", 0) > 0:
        mlp = d * cfg.moe_experts + cfg.moe_experts * 2 * d * cfg.ff_dim
    else:
        mlp = 3 * d * cfg.ff_dim       # SwiGLU: gate, up, down
    return cfg.vocab_size * d + L * (attn + mlp + 2 * d) + d \
        + cfg.vocab_size * d


# Experts a token passes through in an MoE layer: models/moe.py routes
# top-1.
MOE_TOP_K = 1


def transformer_active_param_count(cfg: Any) -> int:
    """The parameters one token passes through: ``transformer_param_count``
    with an MoE layer's experts cut to the ``MOE_TOP_K`` a token is routed
    to (its router stays).  The capacity factor is not counted: the
    padded capacity slots and the dispatch/combine einsums are the
    implementation's work, not the model's, which is what MFU counts."""
    n = transformer_param_count(cfg)
    experts = getattr(cfg, "moe_experts", 0)
    if experts > 0:
        n -= cfg.num_layers * (experts - MOE_TOP_K) * 2 * cfg.d_model \
            * cfg.ff_dim
    return n


def transformer_train_flops(cfg: Any, batch: int, seq: int,
                            n_params: int | None = None) -> float:
    """FLOPs of ONE train step (fwd+bwd): 6*P per token of matmul work,
    P the active parameters (``transformer_active_param_count``), plus the
    attention term 12*L*d*S (halved when causal), the PaLM-appendix
    accounting MFU is defined against."""
    p = n_params if n_params else transformer_active_param_count(cfg)
    tokens = batch * seq
    attn = 12.0 * cfg.num_layers * cfg.d_model * seq \
        * (0.5 if getattr(cfg, "causal", True) else 1.0)
    return tokens * (6.0 * p + attn)


def transformer_decode_flops(cfg: Any, context_len: float,
                             n_params: int | None = None) -> float:
    """FLOPs of ONE generated token at KV context ``context_len``
    (forward only: 2*P matmul, P the active parameters, + 4*L*d*ctx
    attention reads — the same for the dense and paged KV layouts)."""
    p = n_params if n_params else transformer_active_param_count(cfg)
    return 2.0 * p + 4.0 * cfg.num_layers * cfg.d_model * context_len


# ---------------------------------------------------------------------------
# FLOPs — the conv models in models/
# ---------------------------------------------------------------------------
def _conv_flops(c_in: int, c_out: int, k: int, hw: float) -> float:
    return 2.0 * k * k * c_in * c_out * hw * hw


def vgg_forward_flops(stages, image_size: int = 224,
                      num_classes: int = 1000) -> float:
    """Walk a VGG stage plan of (convs, filters): 3x3 SAME convs, a 2x2
    pool after each stage, then the two 4096 Dense layers and the head."""
    hw = float(image_size)
    c_in, total = 3, 0.0
    for n_convs, filters in stages:
        for _ in range(n_convs):
            total += _conv_flops(c_in, filters, 3, hw)
            c_in = filters
        hw /= 2.0
    flat = c_in * hw * hw
    total += 2.0 * (flat * 4096 + 4096 * 4096 + 4096 * num_classes)
    return total


def resnet_forward_flops(stage_sizes, bottleneck: bool = True,
                         num_filters: int = 64, image_size: int = 224,
                         num_classes: int = 1000) -> float:
    """Walk the ResNet stage plan (models/resnet.py): 7x7/2 stem, /2
    pool, stages with stride-2 first blocks, global pool, Dense head."""
    hw = image_size / 2.0
    total = _conv_flops(3, num_filters, 7, hw)
    hw /= 2.0                                   # max_pool /2
    c_in = num_filters
    for i, block_count in enumerate(stage_sizes):
        f = num_filters * 2 ** i
        c_out = 4 * f if bottleneck else f
        for j in range(block_count):
            if j == 0 and i > 0:
                hw /= 2.0                       # stride-2 first block
            if bottleneck:
                total += _conv_flops(c_in, f, 1, hw) \
                    + _conv_flops(f, f, 3, hw) \
                    + _conv_flops(f, c_out, 1, hw)
            else:
                total += _conv_flops(c_in, f, 3, hw) \
                    + _conv_flops(f, f, 3, hw)
            if j == 0 and c_in != c_out:
                total += _conv_flops(c_in, c_out, 1, hw)  # projection
            c_in = c_out
    return total + 2.0 * c_in * num_classes


# InceptionV3 at 299x299 is ~5.7e9 multiply-adds (the published figure
# for the V3 layer plan models/inception.py implements); conv work
# scales with spatial area.
_INCEPTION3_FWD_FLOPS_299 = 2.0 * 5.7e9


def inception3_forward_flops(image_size: int = 299) -> float:
    return _INCEPTION3_FWD_FLOPS_299 * (image_size / 299.0) ** 2


def model_step_flops(model: Any, batch: int, *, seq: int = 0,
                     image_size: int = 224, train: bool = True,
                     n_params: int | None = None) -> float:
    """FLOPs of one step of one of the port's models (train = 3x the
    forward: the standard fwd+bwd accounting).  Any other model raises
    TypeError."""
    from ..models import VGG, InceptionV3, ResNet, TransformerLM
    from ..models.resnet import BottleneckBlock
    if isinstance(model, TransformerLM):
        if train:
            return transformer_train_flops(model.cfg, batch, max(seq, 1),
                                           n_params)
        return batch * transformer_decode_flops(model.cfg, max(seq, 1),
                                                n_params)
    if isinstance(model, VGG):
        fwd = batch * vgg_forward_flops(model.stage_plan, image_size)
    elif isinstance(model, ResNet):
        fwd = batch * resnet_forward_flops(
            model.stage_sizes, issubclass(model.block_cls, BottleneckBlock),
            model.num_filters, image_size)
    elif isinstance(model, InceptionV3):
        fwd = batch * inception3_forward_flops(image_size)
    else:
        raise TypeError(f"no FLOP count for {type(model).__name__}: the "
                        "model is none of TransformerLM, ResNet, VGG and "
                        "InceptionV3")
    return 3.0 * fwd if train else fwd


def mfu(flops_per_step: float, step_seconds: float,
        peak: float) -> float:
    """Model FLOPs utilization: achieved / peak."""
    if step_seconds <= 0.0 or peak <= 0.0:
        return 0.0
    return flops_per_step / step_seconds / peak


# ---------------------------------------------------------------------------
# The ledger — rank snapshots merged into the PERF.json tables
# ---------------------------------------------------------------------------
BUSBW_METRIC = "horovod_collective_busbw_mbps"

_LEDGER_LABELS = ("plane", "op", "codec", "algo", "size_bucket")


def _merged_quantile(buckets: list[list[float]], q: float) -> float:
    """Geometric-interpolated quantile over merged [bound, count] bucket
    lists (the snapshot schema; Histogram.quantile's math without the
    min/max clamp, which does not survive a merge)."""
    count = sum(n for _, n in buckets)
    if count == 0:
        return 0.0
    target = q * count
    cum = 0.0
    for bound, n in sorted(buckets):
        prev, cum = cum, cum + n
        if cum >= target:
            frac = (target - prev) / n
            lo = bound / 2.0
            return lo * (bound / lo) ** frac
    return sorted(buckets)[-1][0]


def _fold_histograms(snapshots: list[dict], name: str) -> dict[tuple, dict]:
    """label tuple -> merged {count, sum, buckets} across rank dumps."""
    cells: dict[tuple, dict] = {}
    for snap in snapshots:
        for entry in snap.get("metrics", ()):
            if entry.get("name") != name \
                    or entry.get("type") != "histogram":
                continue
            labels = entry.get("labels", {})
            key = tuple(labels.get(k, "") for k in _LEDGER_LABELS)
            cell = cells.setdefault(
                key, {"count": 0, "sum": 0.0, "buckets": {}})
            cell["count"] += int(entry.get("count", 0))
            cell["sum"] += float(entry.get("sum", 0.0))
            for bound, n in entry.get("buckets", ()):
                cell["buckets"][bound] = cell["buckets"].get(bound, 0) + n
    return cells


def _gauge_value(snapshots: list[dict], name: str) -> float | None:
    """Max of a gauge across rank dumps (None when absent everywhere)."""
    values = [float(e.get("value", 0.0))
              for snap in snapshots for e in snap.get("metrics", ())
              if e.get("name") == name and e.get("type") == "gauge"]
    return max(values) if values else None


def build_ledger(snapshots: list[dict], topology: Any = None, *,
                 peak_mbps: float = 0.0, min_samples: int = 1) -> dict:
    """Merge rank metric snapshots into the perf ledger.

    ``peak_mbps`` <= 0 self-calibrates: the best measured cell is the
    roofline, so every efficiency lands in (0, 1] and says how far below
    the best this fabric demonstrated each cell is.  An explicit peak
    answers the absolute question instead."""
    if topology is None:
        from ..common.topology import Topology
        topology = Topology(size=max(len(snapshots), 1))
    cells = _fold_histograms(snapshots, BUSBW_METRIC)
    rows = []
    for key in sorted(cells):
        cell = cells[key]
        if cell["count"] < max(min_samples, 1):
            continue
        labels = dict(zip(_LEDGER_LABELS, key))
        buckets = [[b, n] for b, n in cell["buckets"].items()]
        rows.append({
            **labels,
            "samples": cell["count"],
            "busbw_mbps": cell["sum"] / cell["count"],
            "p50_mbps": _merged_quantile(buckets, 0.5),
            "algo_overhead": algo_overhead(labels["algo"], topology),
        })
    calibrated = peak_mbps
    if calibrated <= 0.0:
        calibrated = max((r["busbw_mbps"] for r in rows), default=0.0)
    for r in rows:
        roofline = calibrated / r["algo_overhead"]
        r["roofline_mbps"] = roofline
        # Fabric efficiency: against the peak itself (what perfcheck
        # trends).
        r["efficiency"] = r["busbw_mbps"] / calibrated \
            if calibrated > 0.0 else 0.0
        # Schedule efficiency: against what this algorithm can at best
        # do; above 1 the overhead model is pessimistic for this fabric
        # (informational, never gated).
        r["algo_efficiency"] = r["busbw_mbps"] / roofline \
            if roofline > 0.0 else 0.0
    ledger: dict = {
        "schema": 1,
        "world": {"ranks": int(getattr(topology, "size", len(snapshots))
                               or len(snapshots)),
                  "dumps": len(snapshots),
                  "topology": topology.describe()
                  if hasattr(topology, "describe") else "flat"},
        "peak_mbps": calibrated,
        "peak_source": "knob" if peak_mbps > 0.0 else "self-calibrated",
        "busbw": rows,
    }
    step = {}
    for gauge, field in (("horovod_train_mfu", "train_mfu"),
                         ("horovod_train_step_flops", "train_step_flops"),
                         ("horovod_serve_tokens_per_sec",
                          "serve_tokens_per_sec"),
                         ("horovod_serve_flops_per_token",
                          "serve_flops_per_token"),
                         ("horovod_serve_mfu", "serve_mfu")):
        value = _gauge_value(snapshots, gauge)
        if value is not None:
            step[field] = value
    if step:
        ledger["step"] = step
    return ledger


def ledger_summary(ledger: dict, top: int = 6) -> list[str]:
    """Compact human lines for console and report rendering."""
    rows = ledger.get("busbw", [])
    if not rows:
        return ["no busbw samples (HOROVOD_METRICS off, or no "
                "collectives executed)"]
    out = [f"peak {ledger.get('peak_mbps', 0.0):.1f} MB/s "
           f"({ledger.get('peak_source', '?')}), "
           f"{len(rows)} cells, "
           f"world {ledger.get('world', {}).get('ranks', '?')}"]
    ranked = sorted(rows, key=lambda r: -r["samples"])[:top]
    for r in ranked:
        out.append(f"  {r['plane']}/{r['op']}/{r['algo']}"
                   f"@{r['size_bucket']}: "
                   f"{r['busbw_mbps']:.1f} MB/s "
                   f"eff={r['efficiency']:.2f} "
                   f"(n={r['samples']})")
    step = ledger.get("step", {})
    if step:
        out.append("  step: " + " ".join(
            f"{k}={v:.4g}" for k, v in sorted(step.items())))
    return out
