"""Runtime autotuner for fusion threshold and cycle time.

The port's own copy of ``horovod_tpu/common/parameter_manager.py``: the
codec sweep, the pipeline sweep (segment bytes x streams), the
fused-kernel sweep, the algorithm x tree-threshold sweep, then Bayesian
optimization over (log2 fusion threshold, cycle ms), each proposing
through the controller's ``pending_tuned_*`` fields.

Reference: horovod/common/parameter_manager.{cc,h}:42-120 — scores each
parameter setting by aggregate allreduce bytes/sec over a sampling window,
drives new settings from Bayesian optimization, and broadcasts winning
parameters from the coordinator so every rank stays consistent
(reference: Controller::SynchronizeParameters, controller.cc:39-53; here the
sync rides the ResponseList `tuned_*` fields).
"""
from __future__ import annotations

import time

from . import config
from .logging import logger
from .optim.bayesian_optimization import BayesianOptimization

# Search space: log2(fusion threshold bytes) × cycle time ms.
_THRESHOLD_LOG2_BOUNDS = (20.0, 28.0)      # 1 MiB .. 256 MiB
_CYCLE_MS_BOUNDS = (1.0, 25.0)


class ParameterManager:
    def __init__(self, controller, active: bool) -> None:
        self._controller = controller
        self._active = active           # only the coordinator tunes
        self._warmup_left = config.AUTOTUNE_WARMUP_SAMPLES.get()
        self._steps_per_sample = config.AUTOTUNE_STEPS_PER_SAMPLE.get()
        self._max_samples = config.AUTOTUNE_BAYES_OPT_MAX_SAMPLES.get()
        self._bo = BayesianOptimization(
            [_THRESHOLD_LOG2_BOUNDS, _CYCLE_MS_BOUNDS],
            alpha=config.AUTOTUNE_GAUSSIAN_PROCESS_NOISE.get())
        self._log_path = config.AUTOTUNE_LOG.get()
        if self._log_path and active:
            with open(self._log_path, "w") as f:
                f.write("timestamp,fusion_threshold,cycle_time_ms,score,"
                        "event\n")

        self._steps = 0
        self._bytes = 0
        self._t0 = time.monotonic()
        self._done = False
        self._current = (float(controller.tensor_fusion_threshold),
                         float(config.CYCLE_TIME.get()))

        # Codec sweep (HOROVOD_AUTOTUNE_COMPRESSION): before the BO
        # phase, score each candidate wire codec for one sample window by
        # the same logical-bytes/sec metric — a faster wire moves more
        # gradient bytes per second — and broadcast the winner through
        # ResponseList.tuned_codec.  Candidates stay conservative (the
        # codecs whose accuracy story needs no per-model judgement rides
        # on error feedback for int8; uint4 is opt-in only).
        self._codec_candidates: list[str] = \
            ["none", "fp16", "int8"] if active and \
            config.AUTOTUNE_COMPRESSION.get() else []
        self._codec_scores: dict[str, float] = {}
        self._codec_index = 0

        # TCP-pipeline sweep (HOROVOD_AUTOTUNE_PIPELINE): after the codec
        # sweep, score (segment bytes x active streams) combinations one
        # sample window each — the same logical-bytes/sec metric — and
        # broadcast the winner through ResponseList.tuned_segment_bytes /
        # tuned_num_streams.  Stream width can only be swept up to
        # HOROVOD_NUM_STREAMS (the per-stream channel sets were formed at
        # init; activation is the runtime knob).
        self._pipeline_candidates: list[tuple[int, int]] = []
        if active and config.AUTOTUNE_PIPELINE.get():
            max_streams = max(config.NUM_STREAMS.get(), 1)
            segments = [0, 1 << 16, 1 << 18, 1 << 20]
            self._pipeline_candidates = [
                (seg, s) for s in range(1, max_streams + 1)
                for seg in segments]
        self._pipeline_scores: dict[tuple[int, int], float] = {}
        self._pipeline_index = 0

        # Fused-kernel sweep (rides HOROVOD_AUTOTUNE_PIPELINE): after the
        # pipeline sweep, score the single-pass fused codec legs against
        # the reference dequant/requant chain for one window each and pin
        # the winner through ResponseList.tuned_fused.  Both settings are
        # bitwise identical, so the sweep is purely a speed question —
        # fused wins on codec-heavy wires, and on pure-fp32 rings the two
        # are the same code path (sweeping stays cheap either way).
        self._fused_candidates: list[int] = \
            [1, 0] if active and config.AUTOTUNE_PIPELINE.get() else []
        self._fused_scores: dict[int, float] = {}
        self._fused_index = 0

        # Allreduce-algorithm sweep (rides HOROVOD_AUTOTUNE_PIPELINE):
        # after the fused sweep, score (algo, tree threshold) candidates
        # one window each and pin the winner through
        # ResponseList.tuned_algo / tuned_tree_threshold.  Candidates are
        # (ALGO_NAMES index, threshold bytes): the pure flat ring as the
        # baseline, then "auto" selection at increasing tree/ring
        # crossover thresholds — each one a different small-tensor
        # latency/bandwidth trade on the live workload.
        self._algo_candidates: list[tuple[int, int]] = []
        if active and config.AUTOTUNE_PIPELINE.get():
            from .topology import algo_index
            ring, auto = algo_index("ring"), algo_index("auto")
            self._algo_candidates = [
                (ring, 0), (auto, 1 << 14), (auto, 1 << 16),
                (auto, 1 << 18)]
        self._algo_scores: dict[tuple[int, int], float] = {}
        self._algo_index = 0

    def observe(self, tensor_names: list[str], nbytes: int) -> None:
        """Called once per background cycle with the allreduced bytes."""
        if not self._active or self._done:
            return
        self._bytes += nbytes
        if nbytes > 0:
            self._steps += 1
        if self._steps < self._steps_per_sample:
            return

        elapsed = max(time.monotonic() - self._t0, 1e-9)
        score = self._bytes / elapsed
        self._steps = 0
        self._bytes = 0
        self._t0 = time.monotonic()

        if self._warmup_left > 0:
            self._warmup_left -= 1
            return

        if self._codec_candidates:
            from ..compress import codec_from_name
            if self._codec_index > 0:
                # This window measured the previously proposed codec.
                measured = self._codec_candidates[self._codec_index - 1]
                self._codec_scores[measured] = score
                self._log(*self._current, score,
                          event=f"codec-{measured}")
            if self._codec_index < len(self._codec_candidates):
                nxt = self._codec_candidates[self._codec_index]
                self._codec_index += 1
                self._controller.pending_tuned_codec = int(
                    codec_from_name(nxt))
                return
            # Sweep complete: pin the winner, then continue into BO.
            best = max(self._codec_scores, key=self._codec_scores.get)
            self._controller.pending_tuned_codec = int(
                codec_from_name(best))
            self._log(*self._current, self._codec_scores[best],
                      event=f"codec-winner-{best}")
            logger.info("autotune codec sweep: %s -> %s",
                        self._codec_scores, best)
            self._codec_candidates = []
            return

        if self._pipeline_candidates:
            if self._pipeline_index > 0:
                measured = self._pipeline_candidates[
                    self._pipeline_index - 1]
                self._pipeline_scores[measured] = score
                self._log(*self._current, score,
                          event=f"pipeline-{measured[0]}x{measured[1]}")
            if self._pipeline_index < len(self._pipeline_candidates):
                seg, streams = self._pipeline_candidates[
                    self._pipeline_index]
                self._pipeline_index += 1
                self._controller.pending_tuned_pipeline = (seg, streams)
                return
            best = max(self._pipeline_scores, key=self._pipeline_scores.get)
            self._controller.pending_tuned_pipeline = best
            self._log(*self._current, self._pipeline_scores[best],
                      event=f"pipeline-winner-{best[0]}x{best[1]}")
            logger.info("autotune pipeline sweep: %s -> segment=%d "
                        "streams=%d", self._pipeline_scores, *best)
            self._pipeline_candidates = []
            return

        if self._fused_candidates:
            if self._fused_index > 0:
                measured = self._fused_candidates[self._fused_index - 1]
                self._fused_scores[measured] = score
                self._log(*self._current, score,
                          event=f"fused-{measured}")
            if self._fused_index < len(self._fused_candidates):
                nxt = self._fused_candidates[self._fused_index]
                self._fused_index += 1
                self._controller.pending_tuned_fused = nxt
                return
            best = max(self._fused_scores, key=self._fused_scores.get)
            self._controller.pending_tuned_fused = best
            self._log(*self._current, self._fused_scores[best],
                      event=f"fused-winner-{best}")
            logger.info("autotune fused-kernel sweep: %s -> fused=%d",
                        self._fused_scores, best)
            self._fused_candidates = []
            return

        if self._algo_candidates:
            from .topology import ALGO_NAMES, algo_name
            if self._algo_index > 0:
                measured = self._algo_candidates[self._algo_index - 1]
                self._algo_scores[measured] = score
                self._log(*self._current, score,
                          event=f"algo-{algo_name(measured[0])}"
                                f"@{measured[1]}")
            if self._algo_index < len(self._algo_candidates):
                cand = self._algo_candidates[self._algo_index]
                self._algo_index += 1
                self._controller.pending_tuned_algo = cand
                return
            best = max(self._algo_scores, key=self._algo_scores.get)
            self._controller.pending_tuned_algo = best
            self._log(*self._current, self._algo_scores[best],
                      event=f"algo-winner-{algo_name(best[0])}"
                            f"@{best[1]}")
            logger.info("autotune algo sweep: %s -> algo=%s threshold=%d",
                        self._algo_scores, ALGO_NAMES[best[0]], best[1])
            self._algo_candidates = []
            return

        import math
        threshold, cycle = self._current
        self._bo.add_sample(
            [math.log2(max(threshold, 1.0)), cycle], score)
        self._log(threshold, cycle, score)

        if self._bo.num_samples >= self._max_samples:
            best = self._bo.best()
            assert best is not None
            (log_thr, cycle), best_score = best
            self._propose(2.0 ** log_thr, cycle)
            self._done = True
            self._log(2.0 ** log_thr, cycle, best_score,
                      event="converged")
            logger.info(
                "autotune converged: fusion_threshold=%d cycle_time=%.1fms "
                "(%.1f MB/s)", int(2.0 ** log_thr), cycle,
                best_score / 1e6)
            return

        log_thr, cycle = self._bo.suggest_next()
        self._propose(2.0 ** log_thr, cycle)

    def _propose(self, threshold: float, cycle_ms: float) -> None:
        self._current = (threshold, cycle_ms)
        # Stamped onto the next broadcast ResponseList so all ranks apply
        # identical parameters on the same cycle.
        self._controller.pending_tuned_params = (int(threshold),
                                                 float(cycle_ms))

    def _log(self, threshold: float, cycle: float, score: float,
             event: str = "sample") -> None:
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"{time.time()},{int(threshold)},{cycle},{score},"
                        f"{event}\n")
