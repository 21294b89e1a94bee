"""The environment knobs this package reads.

The same ``HOROVOD_*`` names, types and meanings as the JAX package's
registry (``horovod_tpu/common/config.py``), kept here as a copy of the
ones the port uses so that the port imports nothing of that package.  Two
things differ: a value that does not parse raises, where the registry
falls back to the default, and the default of
``STREAMING_CE_MIN_ELEMENTS`` is ``None``, which is what leaving it unset
means in the reference's training step too.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str            # environment variable
    default: Any
    parser: Callable[[str], Any]
    doc: str = ""

    def get(self) -> Any:
        """The value set in the environment, else the default; a value
        that does not parse raises."""
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parser(raw)
        except (ValueError, TypeError) as exc:
            raise ValueError(f"{self.name} must be a plain "
                             f"{self.parser.__name__} (got {raw!r})") from exc


FUSION_THRESHOLD = Knob(
    "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
    "Tensor-fusion bucket threshold in bytes; the default of "
    "GradSyncConfig.fusion_threshold_bytes.")
TRACK_ACCURACY = Knob(
    "HOROVOD_TRACK_ACCURACY", True, _parse_bool,
    "Compute the per-step training-accuracy metric in Trainer.step.  For "
    "LM-head-sized logits the argmax is a full extra read of the logits; "
    "disable for throughput runs.")
STREAMING_CE_MIN_ELEMENTS = Knob(
    "HOROVOD_STREAMING_CE_MIN_ELEMENTS", None, int,
    "Logit-tensor element count above which the loss streams over the "
    "vocab axis; unset (None) derives the threshold from device memory "
    "(memory/16), 0 forces streaming everywhere (training.py).")

FLEET = Knob(
    "HOROVOD_FLEET", False, _parse_bool,
    "The unified train+serve fleet controller; Trainer.fit raises on it "
    "(the fleet runtime is ROADMAP queue A item 12).")

# --- Inference serving (serving/; the reference's docs/serving.md) ----------
SERVE_MAX_BATCH = Knob(
    "HOROVOD_SERVE_MAX_BATCH", 8, int,
    "Decode slots per replica: the continuous batcher admits new "
    "requests into in-flight decode batches up to this many concurrent "
    "sequences per replica (the KV cache is allocated for exactly this "
    "batch).")
SERVE_TOKEN_BUDGET = Knob(
    "HOROVOD_SERVE_TOKEN_BUDGET", 256, int,
    "Per-replica token budget of one serve step: prefill tokens of newly "
    "admitted requests plus one decode token per active slot must fit; "
    "the batcher defers admissions that would exceed it.")
SERVE_QUEUE_DEPTH = Knob(
    "HOROVOD_SERVE_QUEUE_DEPTH", 1024, int,
    "Front-end ingress queue bound; submissions beyond it are shed at "
    "the door, never buffered.")
SERVE_SLO_MS = Knob(
    "HOROVOD_SERVE_SLO_MS", 30000.0, float,
    "Default per-request SLO in ms, stamped as an absolute deadline at "
    "ingress; admission sheds a request that cannot finish inside it.")
SERVE_SHED_QUEUE_FRACTION = Knob(
    "HOROVOD_SERVE_SHED_QUEUE_FRACTION", 0.9, float,
    "Admission sheds new requests while the queue depth exceeds this "
    "fraction of HOROVOD_SERVE_QUEUE_DEPTH.")
SERVE_MAX_SEQ = Knob(
    "HOROVOD_SERVE_MAX_SEQ", 256, int,
    "KV-cache length per decode slot (prompt + generated tokens).")
SERVE_GROUP_SIZE = Knob(
    "HOROVOD_SERVE_GROUP_SIZE", 1, int,
    "Ranks per serving replica group: 1 = pure data-parallel; N > 1 runs "
    "each group's members in lockstep on identical batch plans.  Must "
    "divide the world size, else it falls back to 1.")
SERVE_PAGED = Knob(
    "HOROVOD_SERVE_PAGED", False, _parse_bool,
    "Paged KV cache (serving/kvpool.py): slot KV state lives in "
    "fixed-size blocks from a per-replica pool, with prefix caching and "
    "copy-on-write block sharing.")
SERVE_BLOCK_TOKENS = Knob(
    "HOROVOD_SERVE_BLOCK_TOKENS", 16, int,
    "Tokens per KV block under HOROVOD_SERVE_PAGED: the unit of "
    "allocation, prefix hashing and copy-on-write.")
SERVE_POOL_BLOCKS = Knob(
    "HOROVOD_SERVE_POOL_BLOCKS", 0, int,
    "KV blocks in the per-replica paged pool (0 = auto: "
    "HOROVOD_SERVE_MAX_BATCH x ceil(max_seq / block_tokens), the dense "
    "layout's token memory).")
SERVE_PAGED_SLOTS = Knob(
    "HOROVOD_SERVE_PAGED_SLOTS", 0, int,
    "Decode slots per replica under HOROVOD_SERVE_PAGED (0 = auto: 2 x "
    "HOROVOD_SERVE_MAX_BATCH), backed by the shared block pool.")
SERVE_MAX_DEFERRALS = Knob(
    "HOROVOD_SERVE_MAX_DEFERRALS", 8, int,
    "Steps a queued prompt may be deferred before the batcher turns it "
    "urgent (it then bypasses the token budget and holds back everything "
    "behind it), so small prompts cannot starve a large one.")
SERVE_PREFILL_RANKS = Knob(
    "HOROVOD_SERVE_PREFILL_RANKS", 0, int,
    "Disaggregated prefill/decode: the highest N ranks prefill only and "
    "stream KV blocks to the decode ranks over a dedicated PeerMesh "
    "(serving/kvstream.py, CRC'd addressed chunks), so long prompts never "
    "occupy a decode step.  0 = every rank prefills its own admissions "
    "(clamped so at least one decode rank remains; needs "
    "HOROVOD_SERVE_PAGED).")
SERVE_KVSTREAM_CHUNK_BYTES = Knob(
    "HOROVOD_SERVE_KVSTREAM_CHUNK_BYTES", 1 << 18, int,
    "Chunk size of one prefill-to-decode KV-block stream frame "
    "(serving/kvstream.py); each chunk is independently addressed and "
    "CRC-verified on arrival.")


def parse_tristate(value: str) -> bool | None:
    """'1'/'true'/... -> True, '0'/'false'/... -> False, else None (auto)."""
    v = value.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return None


# --- The eager core (core.py; the reference's common/config.py) -------------
# World identity (launcher-set; -1 = unset).
RANK = Knob("HOROVOD_RANK", -1, int, "Global rank of this process.")
SIZE = Knob("HOROVOD_SIZE", -1, int, "Global number of ranks.")
LOCAL_RANK = Knob("HOROVOD_LOCAL_RANK", -1, int, "Rank within this host.")
LOCAL_SIZE = Knob("HOROVOD_LOCAL_SIZE", -1, int, "Ranks on this host.")
CROSS_RANK = Knob("HOROVOD_CROSS_RANK", -1, int, "Host index.")
CROSS_SIZE = Knob("HOROVOD_CROSS_SIZE", -1, int, "Number of hosts.")
HOSTNAME = Knob("HOROVOD_HOSTNAME", "", str, "Assigned hostname.")
HOST_IDS = Knob(
    "HOROVOD_HOST_IDS", "", str,
    "World-wide rank-to-host-index map as comma-separated ints "
    "(\"0,0,1,1\"), set by the launcher from the slot layout so topology "
    "resolution can group ring orders by host even when the layout is "
    "not homogeneous host-major (elastic re-assignments, uneven slots "
    "per host).")
RENDEZVOUS_ADDR = Knob(
    "HOROVOD_GLOO_RENDEZVOUS_ADDR", "", str,
    "Rendezvous KV-store host (control plane over TCP).")
RENDEZVOUS_PORT = Knob(
    "HOROVOD_GLOO_RENDEZVOUS_PORT", -1, int, "Rendezvous KV-store port.")
GLOO_TIMEOUT_SECONDS = Knob(
    "HOROVOD_GLOO_TIMEOUT_SECONDS", 30.0, float,
    "Control-plane connect/recv timeout.")
RENDEZVOUS_REPLICAS = Knob(
    "HOROVOD_RENDEZVOUS_REPLICAS", 0, int,
    "Standby rendezvous replicas launched next to the primary (0 = the "
    "single-server control plane); requires HOROVOD_RENDEZVOUS_WAL_DIR. "
    "Standbys tail the primary's WAL and promote on lease lapse "
    "(runner/controlplane.py).")
RENDEZVOUS_LEASE_MS = Knob(
    "HOROVOD_RENDEZVOUS_LEASE_MS", 3000.0, float,
    "Rendezvous leader lease in milliseconds: the primary renews every "
    "third of it, a standby promotes after ~2x of silence, and a "
    "primary whose lease lapsed must re-verify the log (epoch fence) "
    "before accepting another write.")
RENDEZVOUS_WAL_DIR = Knob(
    "HOROVOD_RENDEZVOUS_WAL_DIR", "", str,
    "Directory of the rendezvous write-ahead log (shared by the "
    "replica set).  Empty = no WAL: the KV is in-memory only and does "
    "not survive coordinator death.")
PROTO_COMPAT = Knob(
    "HOROVOD_PROTO_COMPAT", 0, int,
    "Advertise this wire protocol version (masking newer feature bits) "
    "at every channel HELLO instead of the build's native version; 0 = "
    "native.  The rolling-upgrade lever: peers negotiate the min "
    "common schema per mesh.")
CYCLE_TIME = Knob(
    "HOROVOD_CYCLE_TIME", 1.0, float,
    "Background-loop cycle time in milliseconds.")
CACHE_CAPACITY = Knob(
    "HOROVOD_CACHE_CAPACITY", 1024, int,
    "Response-cache capacity (0 disables caching).")
DISABLE_GROUP_FUSION = Knob(
    "HOROVOD_DISABLE_GROUP_FUSION", False, _parse_bool,
    "Disable fusion across explicitly grouped collectives.")
STALL_CHECK_DISABLE = Knob(
    "HOROVOD_STALL_CHECK_DISABLE", False, _parse_bool,
    "Disable the stalled-tensor warning check.")
STALL_CHECK_TIME_SECONDS = Knob(
    "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0, float,
    "Seconds before warning about ranks with missing submissions.")
STALL_SHUTDOWN_TIME_SECONDS = Knob(
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0, float,
    "Seconds before a stall aborts the job (0 = never).")
TIMELINE = Knob(
    "HOROVOD_TIMELINE", "", str,
    "Path for the Chrome-trace timeline JSON ('DYNAMIC' = start "
    "stopped); ranks > 0 write '<path>.r<rank>'.")
TIMELINE_MARK_CYCLES = Knob(
    "HOROVOD_TIMELINE_MARK_CYCLES", False, _parse_bool,
    "Mark background-loop cycles in the timeline.")
SHM_OPERATIONS = Knob(
    "HOROVOD_SHM_OPERATIONS", "auto", str,
    "Same-host shared-memory data plane: 1=require, 0=disable, auto=use "
    "when every rank shares one memory domain.")
SHM_CAPACITY = Knob(
    "HOROVOD_SHM_CAPACITY", 0, int,
    "Per-rank shm region bytes (0 = max(fusion threshold, 64MB)); "
    "payloads above it fall through to the TCP plane.")
TOPOLOGY = Knob(
    "HOROVOD_TOPOLOGY", "", str,
    "Physical layout declaration: flat | host | torus:RxC.  Empty = auto: "
    "host when the env describes a homogeneous two-level layout, else "
    "flat.  Must be launcher-uniform across ranks.")
ALGO = Knob(
    "HOROVOD_ALGO", "auto", str,
    "Eager-plane allreduce algorithm: auto (tree at or under "
    "HOROVOD_TREE_THRESHOLD_BYTES in worlds above two ranks, torus on a "
    "declared torus, segmented ring otherwise) | ring | tree | rhd | "
    "torus.")
TREE_THRESHOLD_BYTES = Knob(
    "HOROVOD_TREE_THRESHOLD_BYTES", 64 * 1024, int,
    "Payloads at or below this many wire bytes take the tree allreduce "
    "under HOROVOD_ALGO=auto; 0 disables the small-tensor path.")
LOG_LEVEL = Knob("HOROVOD_LOG_LEVEL", "warning", str,
                 "trace|debug|info|warning|error|fatal")
LOG_HIDE_TIME = Knob("HOROVOD_LOG_HIDE_TIME", False, _parse_bool,
                     "Hide timestamps in log output.")
NCCL_OPERATIONS = Knob(
    "HOROVOD_NCCL_OPERATIONS", "auto", str,
    "The device plane for CUDA tensors (backend/nccl.py), in the place of "
    "the reference's HOROVOD_XLA_OPERATIONS: 1 (require the NCCL group; "
    "init raises without a card and NCCL) | 0 (no device plane: a CUDA "
    "tensor in a world of more than one rank raises) | auto (form the "
    "group when the world has more than one rank and this process sees "
    "a CUDA card and NCCL).")
XLA_OPERATIONS = Knob(
    "HOROVOD_XLA_OPERATIONS", "auto", str,
    "The reference's XLA device plane.  The port has none: its device "
    "plane is HOROVOD_NCCL_OPERATIONS, and 1 here raises "
    "NotImplementedError.")

HIERARCHICAL_ALLREDUCE = Knob(
    "HOROVOD_HIERARCHICAL_ALLREDUCE", False, _parse_bool,
    "Two-level allreduce on the host planes (backend/hierarchical.py): "
    "reduce-scatter within a host, allreduce of the owned shard across "
    "hosts, allgather within the host.  Needs the launcher's host-major "
    "layout (or HOROVOD_TOPOLOGY=torus:RxC); otherwise every rank keeps "
    "the flat path.")
HIERARCHICAL_ALLGATHER = Knob(
    "HOROVOD_HIERARCHICAL_ALLGATHER", False, _parse_bool,
    "Two-level allgather on the host planes: a gather within each host, "
    "then one exchange of whole host blocks across hosts.")
COMPRESSION = Knob(
    "HOROVOD_COMPRESSION", "none", str,
    "Default wire codec for eager allreduces: none | fp16 | bf16 | int8 "
    "| uint4.  The quantized codecs apply blockwise scale+zero-point "
    "compression to floating tensors; integer tensors always ride "
    "uncompressed.  A call's compression= argument overrides it.")
COMPRESSION_BLOCK_SIZE = Knob(
    "HOROVOD_COMPRESSION_BLOCK_SIZE", 256, int,
    "Elements per quantization block for the int8/uint4 codecs (even for "
    "uint4); 8 bytes of scale and zero point a block ride the wire.")
FUSED_KERNELS = Knob(
    "HOROVOD_FUSED_KERNELS", True, _parse_bool,
    "Single-pass codec passes on the host planes' quantized and cast legs "
    "(compress/fused.py, over the native qencode/qdecode): bitwise equal "
    "to the per-chunk chain of compress/quantize.py, which 0 selects.")

SEGMENT_BYTES = Knob(
    "HOROVOD_SEGMENT_BYTES", 256 * 1024, int,
    "TCP ring pipeline segment: the receiver consumes each ring chunk in "
    "segments of this many bytes, adding segment k while segment k+1 "
    "streams in (the same sums in the same order).  0 disables "
    "segmentation (one receive and add per chunk).  The autotuner's "
    "pipeline sweep retunes it.")
NUM_STREAMS = Knob(
    "HOROVOD_NUM_STREAMS", 1, int,
    "Parallel response-dispatch streams (upstream Horovod's "
    "HOROVOD_NUM_NCCL_STREAMS): N worker threads run the independent "
    "host-plane responses of one cycle at once, each over its own TCP "
    "channel set.  Round-robin over the coordinator-ordered ResponseList, "
    "the same on every rank; device-plane responses stay on stream 0.  "
    "1 = serial dispatch on the background thread.")

# --- Autotune (the reference's common/parameter_manager.py) -----------------
AUTOTUNE = Knob(
    "HOROVOD_AUTOTUNE", False, _parse_bool,
    "Enable Bayesian autotuning of fusion threshold and cycle time.")
AUTOTUNE_LOG = Knob(
    "HOROVOD_AUTOTUNE_LOG", "", str,
    "CSV file to log autotune samples to.")
AUTOTUNE_WARMUP_SAMPLES = Knob(
    "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3, int,
    "Discarded warmup samples per autotune step.")
AUTOTUNE_STEPS_PER_SAMPLE = Knob(
    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
    "Training steps scored per autotune sample.")
AUTOTUNE_BAYES_OPT_MAX_SAMPLES = Knob(
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
    "Max Bayesian-optimization samples before fixing parameters.")
AUTOTUNE_GAUSSIAN_PROCESS_NOISE = Knob(
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8, float,
    "GP observation-noise hyperparameter (alpha).")
AUTOTUNE_COMPRESSION = Knob(
    "HOROVOD_AUTOTUNE_COMPRESSION", False, _parse_bool,
    "Let the autotuner sweep wire codecs (none/fp16/int8) by measured "
    "allreduce throughput and broadcast the winner to every rank.")
AUTOTUNE_PIPELINE = Knob(
    "HOROVOD_AUTOTUNE_PIPELINE", False, _parse_bool,
    "Let the autotuner sweep the TCP pipeline (segment bytes x active "
    "streams, bounded by HOROVOD_NUM_STREAMS), the fused codec passes "
    "and the allreduce algorithm by measured allreduce throughput before "
    "the Bayesian phase, broadcasting each winner to every rank.")

# --- Collective fingerprinting (analysis/fingerprint.py) --------------------
FINGERPRINT = Knob(
    "HOROVOD_FINGERPRINT", "off", str,
    "Runtime collective-symmetry fingerprinting: off | cycle (compare "
    "rolling per-rank op fingerprints on every natural negotiation "
    "cycle) | strict (force a negotiation every cycle, so divergence is "
    "caught in response-cache steady state too).  Cross-rank divergence "
    "becomes a structured ERROR naming the first divergent op instead of "
    "a stall.")
FINGERPRINT_WINDOW = Knob(
    "HOROVOD_FINGERPRINT_WINDOW", 64, int,
    "Ops of fingerprint history each rank ships with its RequestList; "
    "divergences older than the window are reported as 'at or before' "
    "the oldest commonly-visible op.")

# --- Telemetry (telemetry/) -------------------------------------------------
METRICS = Knob(
    "HOROVOD_METRICS", False, _parse_bool,
    "Per-rank metrics registry and cross-rank straggler aggregation "
    "(on|off).  Off (the default) resolves every instrument to a shared "
    "no-op metric.")
METRICS_PORT = Knob(
    "HOROVOD_METRICS_PORT", 0, int,
    "Base port of the Prometheus text endpoint; rank r serves on port+r "
    "(an ephemeral port if that one is taken).  0 disables the HTTP "
    "server (the registry still records).")
METRICS_FILE = Knob(
    "HOROVOD_METRICS_FILE", "", str,
    "Path of the shutdown JSON metrics dump; '{rank}' substitutes the "
    "rank, otherwise '.r<rank>' goes before the extension.  Empty "
    "disables the dump.")
METRICS_BIND = Knob(
    "HOROVOD_METRICS_BIND", "127.0.0.1", str,
    "Bind address of the Prometheus endpoint; localhost by default "
    "('' or 0.0.0.0 binds every interface).")
METRICS_WINDOW = Knob(
    "HOROVOD_METRICS_WINDOW", 32, int,
    "Negotiated tensors per straggler-aggregation window: the "
    "coordinator publishes min/mean/max/p99 cross-rank arrival lag and "
    "names the slowest rank once per window.")
STRAGGLER_THRESHOLD_MS = Knob(
    "HOROVOD_STRAGGLER_THRESHOLD_MS", 5.0, float,
    "Mean arrival lag (ms behind the fastest rank, per window) above "
    "which the coordinator logs a straggler warning and sets the "
    "straggler-rank gauge.")

# --- perfscope roofline accounting (telemetry/perfmodel.py) -----------------
PERF_PEAK_MBPS = Knob(
    "HOROVOD_PERF_PEAK_MBPS", 0.0, float,
    "Peak per-link bus bandwidth (MB/s) the perfscope roofline divides "
    "measured busbw by.  0 = self-calibrate: the best measured (plane, "
    "algo, codec, size-bucket) cell in the ledger window is the "
    "roofline.")
PERF_PEAK_FLOPS = Knob(
    "HOROVOD_PERF_PEAK_FLOPS", 0.0, float,
    "Peak dense FLOP/s of one card, the MFU gauges' denominator.  0 = "
    "the table of NVIDIA cards in telemetry/perfmodel.py, with a nominal "
    "1e12 for unknown kinds (the CPU).")
PERF_TOLERANCE_PCT = Knob(
    "HOROVOD_PERF_TOLERANCE_PCT", 10.0, float,
    "Regression-gate tolerance: telemetry.perfcheck fails (exit 1, "
    "structured finding) when a (plane, op, size-bucket) busbw cell or "
    "the MFU drops more than this percentage below the baseline "
    "ledger.")
PERF_MIN_SAMPLES = Knob(
    "HOROVOD_PERF_MIN_SAMPLES", 1, int,
    "Observations a (plane, op, codec, algo, size-bucket) cell needs "
    "before the perf ledger includes it.")

# --- Flight recorder (telemetry/flight.py) ----------------------------------
FLIGHT = Knob(
    "HOROVOD_FLIGHT", True, _parse_bool,
    "Always-on flight recorder: a bounded ring of recent trace events per "
    "rank (enqueue, dispatch, completion, failure conversions), dumped "
    "as rank-stamped JSON when a structured failure fires (fingerprint "
    "divergence, SIGTERM).  0: a shared no-op recorder and no signal "
    "handler.")
FLIGHT_EVENTS = Knob(
    "HOROVOD_FLIGHT_EVENTS", 256, int,
    "Ring capacity of the flight recorder.")
FLIGHT_FILE = Knob(
    "HOROVOD_FLIGHT_FILE", "horovod_flight.json", str,
    "Path of the flight-recorder dump; '{rank}' substitutes, otherwise "
    "'.r<rank>' goes before the extension.  Written only when a "
    "structured failure fires.")

# --- Elastic state streaming (statesync/ subsystem) ------
STATESYNC = Knob(
    "HOROVOD_STATESYNC", False, _parse_bool,
    "Peer-to-peer live state streaming + the grow side of elasticity: "
    "a per-step membership check (one tiny symmetric collective) lets "
    "incumbents admit a joining rank at a step boundary, donate a "
    "copy-on-write state snapshot from live peers (no checkpoint file, "
    "no training pause), and rebuild the world one rank larger once the "
    "joiner's streamed state digest-verifies.  Off (the default) adds "
    "no collectives and no threads.")
STATESYNC_CHUNK_BYTES = Knob(
    "HOROVOD_STATESYNC_CHUNK_BYTES", 1 << 20, int,
    "Chunk size of one streamed state frame (donor->joiner).  Chunks "
    "are independently addressed (offset, length, crc), so a transfer "
    "resumes at chunk granularity when a donor dies mid-stream.")
STATESYNC_POLL_SECONDS = Knob(
    "HOROVOD_STATESYNC_POLL_SECONDS", 0.1, float,
    "Interval of the statesync watcher thread's rendezvous-KV polls "
    "for join announcements / joiner-ready marks.")
STATESYNC_TIMEOUT_SECONDS = Knob(
    "HOROVOD_STATESYNC_TIMEOUT_SECONDS", 60.0, float,
    "Deadline for one streaming round (mesh formation + transfer + "
    "verify) on both the donor and joiner side; a round that exceeds "
    "it is abandoned (the joiner re-announces, donors stand down).")
STATESYNC_WORLD = Knob(
    "HOROVOD_STATESYNC_WORLD", "world", str,
    "Name of this process's world-membership record in the coordinator "
    "KV (scope 'statesync').  A fleet deployment runs TWO live worlds "
    "— training and serving — against one coordinator "
    "(fleet/controller.py), so each names its record distinctly "
    "('train' / 'serve') and a joiner targets the right one; single-"
    "world deployments keep the default.")
PREEMPT_GRACE_SECONDS = Knob(
    "HOROVOD_PREEMPT_GRACE_S", 0.0, float,
    "Preemption-notice grace window: > 0 installs a SIGTERM handler "
    "that lets the rank finish its in-flight step, announce an orderly "
    "departure through the statesync membership check (survivors "
    "shrink proactively — no RanksFailedError, no heartbeat deadline), "
    "write its bye| liveness stamp and exit 0.  If no step boundary "
    "arrives within the window, a backstop stamps bye|, dumps the "
    "flight recorder and re-delivers the default SIGTERM disposition.  "
    "0 (the default) keeps the stock SIGTERM behavior.")
PREEMPT_DONATE = Knob(
    "HOROVOD_PREEMPT_DONATE", True, _parse_bool,
    "On an orderly preemption departure, fast-donate this rank's "
    "ring-sharded (ZeRO) optimizer-state shard to the rendezvous KV so "
    "survivors can re-shard without the departed rank (only when the "
    "training loop registered a shard provider; see docs/statesync.md).")

# --- Autoscale policy loop (statesync/autoscale.py) -------------------------
AUTOSCALE = Knob(
    "HOROVOD_AUTOSCALE", False, _parse_bool,
    "Rank-0 autoscale controller thread: watches the straggler-lag / "
    "queue-depth gauges (telemetry/) and the serving shed rate, and "
    "drives the elastic driver's target world size up/down with "
    "hysteresis.  Decisions are metrics + flight-recorder events.")
AUTOSCALE_INTERVAL_SECONDS = Knob(
    "HOROVOD_AUTOSCALE_INTERVAL_S", 5.0, float,
    "Observation interval of the autoscale controller loop.")
AUTOSCALE_UP_SHED_RATE = Knob(
    "HOROVOD_AUTOSCALE_UP_SHED_RATE", 0.05, float,
    "Scale up when the serving shed rate over one interval exceeds "
    "this fraction (capacity, not deadline, is the binding constraint).")
AUTOSCALE_UP_QUEUE_FRACTION = Knob(
    "HOROVOD_AUTOSCALE_UP_QUEUE_FRACTION", 0.5, float,
    "Scale up when queue depth exceeds this fraction of "
    "HOROVOD_SERVE_QUEUE_DEPTH (or the configured depth limit).")
AUTOSCALE_DOWN_LAG_MS = Knob(
    "HOROVOD_AUTOSCALE_DOWN_LAG_MS", 50.0, float,
    "Scale down when the coordinator straggler lag exceeds this many "
    "ms while the queue is idle and nothing is shed: one dragging rank "
    "costs more step time than its share of the work is worth.")
AUTOSCALE_HYSTERESIS_ROUNDS = Knob(
    "HOROVOD_AUTOSCALE_HYSTERESIS_ROUNDS", 3, int,
    "Consecutive intervals a scale condition must hold before a "
    "decision fires (and the cooldown after each decision), so one "
    "burst never flaps the world size.")

# --- Resilience (resilience/) -----------------------------------------------
FAULT_TOLERANCE = Knob(
    "HOROVOD_FAULT_TOLERANCE", False, _parse_bool,
    "Failure detection + deadline-bounded collectives: heartbeats over "
    "the rendezvous liveness table, socket-level deadlines on every "
    "blocking collective wait, and structured RanksFailedError instead "
    "of a hang when a peer dies or wedges.  Off (the default) keeps "
    "every hot path byte-identical to the pre-resilience behavior: no "
    "monitor thread, no socket timeouts, no per-recv branches beyond "
    "one None test.")
FAULT_TIMEOUT = Knob(
    "HOROVOD_FAULT_TIMEOUT", 30.0, float,
    "Failure-detection window in seconds: a peer whose heartbeat stops "
    "advancing for this long is declared failed, and a blocking "
    "collective wait that exceeds it raises RanksFailedError naming the "
    "unresponsive peer.  Also the default per-op deadline of the "
    "ResilienceContext.")
ON_FAILURE = Knob(
    "HOROVOD_ON_FAILURE", "raise", str,
    "Recovery policy applied by resilience.run_with_recovery when a "
    "collective raises RanksFailedError: raise (safe default) | retry "
    "(re-run an idempotent eager collective with exponential backoff "
    "over rebuilt channels, only while every rank is still live) | "
    "shrink (hand the surviving-rank set to the elastic driver for a "
    "world-resize and blacklist the dead host).")
FAULT_RETRIES = Knob(
    "HOROVOD_FAULT_RETRIES", 3, int,
    "Maximum retry attempts under HOROVOD_ON_FAILURE=retry.")
FAULT_BACKOFF_SECONDS = Knob(
    "HOROVOD_FAULT_BACKOFF_SECONDS", 0.5, float,
    "Base of the exponential retry backoff (attempt k sleeps "
    "base * 2**k seconds).")
CHAOS = Knob(
    "HOROVOD_CHAOS", "", str,
    "Deterministic fault-injection spec (resilience/chaos.py): "
    "';'-separated actions 'kind:key=val,...' — kill/freeze/fail at a "
    "global collective index, delay/drop/dup a specific peer-channel "
    "send.  Empty (the default) installs nothing.  See "
    "docs/resilience.md for the grammar.")
SHM_BARRIER_TIMEOUT_SECONDS = Knob(
    "HOROVOD_SHM_BARRIER_TIMEOUT_SECONDS", 600.0, float,
    "Timeout of the shared-memory plane's 3-phase lockstep barrier; a "
    "rank missing past it aborts the op with a structured error naming "
    "the lagging rank instead of spinning forever.")

# Eager knobs whose feature the port does not have yet: (knob, default,
# parser, roadmap item).  A value other than the default raises at init.
UNPORTED_EAGER_KNOBS = (
    ("HOROVOD_SAN", False, _parse_bool,
     "ROADMAP queue A item 9(d) (the SAN witness, with item 12's static "
     "lock graph)"),
)


def check_eager_knobs() -> None:
    """Raise NotImplementedError for an eager knob set to a feature the
    port lacks."""
    for name, default, parser, item in UNPORTED_EAGER_KNOBS:
        raw = os.environ.get(name, "")
        if raw.strip().lower() in ("", str(default).lower()):
            continue
        if parser(raw) != default:
            raise NotImplementedError(f"{name}={raw} is {item}")
    if parse_tristate(XLA_OPERATIONS.get()) is True:
        raise NotImplementedError(
            "HOROVOD_XLA_OPERATIONS=1 asks for the reference's XLA plane; "
            "the port's device plane is NCCL, HOROVOD_NCCL_OPERATIONS "
            "(ROADMAP queue A item 9(b))")
