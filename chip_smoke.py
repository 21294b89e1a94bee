"""Smoke run of horovod_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels, compiled from ``horovod_tpu_torch/csrc`` with
   nvcc at first use, and what was compiled: for each kernel instance
   ptxas's registers and spill bytes and the counts of its HGMMA (wgmma),
   TMA (UTMALDG, UBLKCP), HMMA (mma.sync) and SYNCS (mbarrier) SASS
   instructions.  The phase fails if a flash kernel has no HGMMA or no
   TMA load or has any HMMA, if any kernel spills, or if an instance is
   missing (``build_problems``);
3. kernels: each of the three flash-attention kernels against its plain
   PyTorch version on the card, in bf16, at the training shape of
   gpt_small (B=8, T=2048, H=12, D=64, causal) and at a non-causal
   tq < tk shape: max abs error against a stated tolerance, kernel and
   plain times (``ms``: one call between two CUDA events, median of 20;
   ``device_ms``: 20 calls queued back to back between the events, median
   of 5 such rounds), the times of ``scaled_dot_product_attention`` on
   the same inputs as a yardstick, taken both ways, and the least time
   the card could take (bound);
4. reference: gpt_tiny on the card with flash attention against the same
   weights with dense attention (logits and one training loss);
5. train: the port's main path, ``Trainer.step`` on gpt_small with flash
   attention, bf16 compute, a bf16 wire through a one-rank NCCL group
   and AdamW(3e-4, wd 1e-4), on ``synthetic_text_batch(8, 2048, 50304)``:
   2 warm-up and 5 timed steps, with the kernels' launch counts read over
   the 7 steps (12 of each a step); then one profiled step; then the
   remat legs, each block checkpointed under ``remat_policy`` "full" and
   "dots": step ms, peak memory, losses and launches (the forward 24 a
   step, dq and dK/dV 12);
6. serve: the port's serving path, ``ReplicaExecutor`` in a world of one
   of the eager core (``hvd.init()``; its plan and completions exchanges
   run through ``hvd.broadcast_object`` and ``hvd.allgather_object``),
   through ``queue.submit`` and ``serve_loop`` on gpt_small at full width (12
   layers, d_model 768, vocab 50304, max_seq 1024), one line a leg:
   fp32 dense and paged legs in which every generated token must be a
   near-argmax (within 1e-3) of the model's full forward over prompt and
   generated tokens; timed bf16 dense and paged legs (tokens/s, step_ms
   and latency p50/p99, peak memory, the paged pool's counters); a
   profile of 8 full-batch dense decode steps; and the loadgen CLI with
   the reference benchmark's serve arguments.  No flash kernel may launch
   while serving: decode attention is plain torch, as in the reference;
7. cnn: the CNN leg of the reference benchmark (``bench.py``'s default
   model), one line a leg over a one-rank NCCL group.  A check leg in
   fp32: ResNet-50 (B=2, 224x224) on the card against the same weights
   on the CPU after one train-mode forward (logits within 1e-4 of
   max|ref|, BatchNorm statistics within 1e-5) and after one SGD step
   through ``Trainer`` (parameters within 1e-5), and the space-to-depth
   stem with folded weights against the conv7 stem (1e-4).  Then timed
   legs in bf16 with a bf16 wire and SGD(0.1, momentum 0.9) at B=128:
   ResNet-50 at 224 (2 warm-up and 5 timed steps, then one profiled
   step), VGG-16 at 224 and Inception V3 at 299 (2 warm-up and 3 timed
   steps each), with ``cudnn.benchmark`` on.  No flash kernel may launch:
   the CNNs run cuDNN convolutions and plain torch, as the reference runs
   XLA's convolutions and no Pallas kernel.

8. sync: the rest of gradient sync over a one-rank NCCL group, one line
   a leg.  The codec leg draws a 64 Mi-element fp32 bucket (what a 64 MiB
   fusion threshold gives at 1 wire byte an element): for int8 and uint4,
   ``quantize_rows`` and ``dequantize_rows`` on the card must equal the
   same calls on the CPU bitwise; ``quantized_allreduce`` of the bucket is
   timed against the bf16-wire all-reduce of it (median of 5), beside the
   bytes a single fused pass would move (10 B an element).  The gpt legs
   train gpt_small as the train phase does with the bf16 wire (the
   baseline), int8, uint4, adasum on the bf16 wire, the ring on the bf16
   wire and the ring with an int8 gradient leg; the resnet50 legs train
   ResNet-50 at B=128 with SGD(0.1, 0.9), int8 and the ring.  Each leg:
   2 warm-up and 3 timed steps (step ms, the mean), the sync alone on the
   last step's gradients between CUDA events (median of 5), peak memory,
   the optimizer state's bytes, the loss at every step and the flash
   launches (12 a gpt step, none in a resnet50 step).  A bitwise
   mismatch, a loss that is not finite or does not fall, or a launch
   count that is off fails the phase.

9. eager: the eager Horovod core (``hvd.init``, the negotiation, the TCP
   and shm planes, the native host kernels) on the card machine's host,
   in worlds spawned against the port's ``RendezvousServer``: the native
   library's build time and CPU tag; a 2-rank world checking the
   collectives battery of ``tests/mp_worker.py:17-107`` in every dtype
   against numpy, with a timeline on every rank (NEGOTIATE_* and op
   events); a 2-rank world timing bench.py's eager leg (the cached cycle
   rate over 200 cycles of a 64-float allreduce after 20, and a 16 MiB
   fp32 allreduce's 2(n-1)/n bandwidth, 5 reps after 2) on the TCP ring
   (natively and through the Python ring) and on the shm plane; a 4-rank
   ladder of ring against tree at 4 KiB, 64 KiB and 1 MiB; the native
   entry points against their plain versions; a 2-rank world on CPU
   tensors with the one card visible to both ranks, where no device
   plane may form, a CUDA tensor is refused, and
   ``HOROVOD_NCCL_OPERATIONS=1`` raises on both ranks; and a CUDA
   tensor's allreduce at one rank, which must stay on the card.

10. binding: the torch binding (``horovod_tpu_torch.torch``) and the
   NCCL device plane, one line a leg.  (a) The user loop: ``hvd.init()``
   (a world of one on cuda:0), ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW(3e-4, wd 1e-4),
   compression=Compression.bf16)``, ``broadcast_optimizer_state``, and 2
   warm-up and 5 timed steps of gpt_small at full width (B=8, T=2048,
   flash attention, bf16 compute): step ms, tokens/s, peak memory, the
   flash launches (12 of each a step), the core's responses and fused
   bytes a step (none: as in the reference, hooks register only in a
   world of more than one rank), a profile with its device-to-host
   copies; then the hooks' path driven by hand on one step's gradients
   (every gradient through the core to the basic plane on the card),
   timed and profiled, every installed gradient bitwise its bf16
   rounding; then 5 more steps of the loop after ``hvd.shutdown()``
   (``AdamW.step`` itself), timed without the core's thread; then
   ``Trainer.step`` on the same weights, batch and bf16 wire over a
   one-rank NCCL group, its step time beside the loop's and the losses
   within 1e-3; and ``Trainer.step`` once more on the plain wire, the
   losses' difference printed.  (b) ``NcclBackend`` on a one-rank NCCL
   group: allreduce (sum, average, scaled, fused), allgather (also
   fused with an empty entry), broadcast, alltoall and reduce-scatter in
   fp16, bf16, fp32, fp64, int8, uint8, int32, int64, int16, uint16 and
   bool, each equal to torch's result on the card; and a 64 MiB fused
   fp32 allreduce timed (at one rank a copy).  (c) The cycle rate of a
   64-float ``hvd.allreduce`` on a CUDA tensor and on a CPU tensor.  (d)
   ``_SyncBatchNormFn`` at one rank against ``F.batch_norm`` in training
   mode, fp32, within 1e-5 of max|ref|.  The native host kernels must
   not run in any of these legs, and no device-to-host copy in the
   profiled step or hook path may be longer than 20 us.

11. reduce: the eager reduction features, one line a leg.  (a) Host
   worlds through ``--eager-worker`` (CUDA hidden): 2 and 4 ranks on the
   TCP and shm planes, through the fused codec passes and the per-chunk
   chain, every codec (fp16, bf16, int8, uint4) at a block-aligned and a
   ring length bitwise equal to a numpy oracle of the reference's
   owner-reduce, and Adasum within one fp32 ulp of
   ``adasum_reference``; a 16 MiB fp32 allreduce on each codec at 2
   ranks (ms, GB/s, the data mesh's bytes sent beside the plain fp32
   ring's: int8 must move 0.258 of them and uint4 0.133, at block 256
   and 8 bytes of metadata a block); and 2 hosts x 2 ranks through the
   hierarchical plane, with shm and with TCP local legs (the two-level
   sum bitwise, a ragged allgather, the legs run).  (b) ``NcclBackend``
   on a one-rank NCCL group: int8/uint4 at 16 Mi and 1,000,003 fp32
   elements bitwise equal to the same code on the CPU tensor and within
   the reference's bound, fp16/bf16 equal to ``x.to(dt).float()``, each
   timed beside the plain allreduce of the same buffer (64 MiB at 16
   Mi), and a profiled int8 call with no device-to-host copy over 20 us.
   (c) Adasum's float64 dot products and combine on the card at
   50304 x 768 elements against numpy's ``adasum_combine`` (1e-12
   relative), timed against their bytes.  (d) gpt_small at one rank
   through ``DistributedOptimizer(op=Adasum)`` and through
   ``compression=Compression.int8``, 2 + 3 steps each: the losses must
   equal the plain AdamW loop's bit for bit (at one rank both are the
   wrapped step) and every flash kernel launch 12 times a step.  With
   two or more cards, (b) and (c) also run across two ranks, one card
   each (``--reduce-card-worker``); with one the summary says so.

12. runtime: the eager core's runtime half, one line a leg.  (a) The
   card leg: gpt_small at full width (B=8, T=2048, bf16, flash
   attention, AdamW(3e-4, wd 1e-4)) in a world of one on cuda:0, each
   step's gradients through ``hvd.grouped_allreduce`` (Average) to the
   basic plane on the card, 2 warm-up, 5 timed and 3 profiled steps
   from the same seed under seven settings, each under a fresh
   ``hvd.init()``: all off (``HOROVOD_FLIGHT=0``), the reference's
   defaults (the flight recorder on), observed (``HOROVOD_METRICS=1``
   with ``HOROVOD_METRICS_PORT``, ``HOROVOD_FINGERPRINT=strict``, a
   timeline and a metrics dump; the exporter scraped once over
   loopback), each of those three instruments alone, and tuned
   (``HOROVOD_AUTOTUNE=1`` with a log, one warm-up window, one step a
   sample, three Bayesian samples).  The profiled steps run under
   ``_HostProfile``, which times the core's pieces (``_core_pieces``)
   on whichever thread runs them; every step records the garbage
   collector's passes, and each setting the threads alive, the heap's
   tracked objects and each grouped allreduce's host ms.  A full
   collection, timed, runs before each setting
   (``CHIP_SMOKE_PRE_COLLECT=0`` skips it).  It prints step ms under
   each setting, the flash launches a step (12 of each), the losses
   (bitwise equal across the settings: an average over one rank is
   exact), the collective bytes a step (equal to the gradients'
   bytes), the collective latency and cycle-ms p50/p99, the cache hit
   rate, the scrape's metric count, and the
   autotuner's log rows and final (threshold, cycle).  (b) Host worlds
   through ``--eager-worker`` job ``runtime`` (CUDA hidden) at 2 and 4
   ranks on the native TCP ring: 16 MiB as 16 fp32 tensors of 1 MiB in
   one cycle with fusion off at ``HOROVOD_NUM_STREAMS`` 1, 2 and 4 (ms,
   GB/s, ``summary()``'s per-stream busy ms and utilization; the
   outputs and ``_eager_check`` against numpy); the pipeline sweep
   (``HOROVOD_AUTOTUNE_PIPELINE=1``), whose applied segment bytes,
   streams and algorithm must be the same on every rank; and a
   fingerprint divergence under ``strict`` (rank 1 submits another
   shape under the same name): every rank must get the structured error
   within seconds.  The system dumps the flight ring on the coordinator
   only, as the reference does, and the dump's tail names the op; on
   the other ranks the script dumps the ring itself (``rec.dump()``) to
   show what it held, and checks that none of them dumped on its own.

13. resilience: the eager core's failure half, one line a leg.  (a) A
   serving world of two ranks through ``--eager-worker rserve-<leg>``,
   both ``ReplicaExecutor(device="cuda")`` on the one card (the TCP
   plane: no NCCL plane forms on one card, shm is off), three quarters
   of the serve phase's timed workload (24 requests, 64-512 prompt
   tokens, 64 new, max_batch 8, dense: the two replicas' 16 slots, then
   8 more) on gpt_small in fp32, with
   ``HOROVOD_FAULT_TOLERANCE`` off and then on (``HOROVOD_FAULT_TIMEOUT``
   5 s): tokens/s, step_ms p50/p99, the exchanges' host ms a step, the
   threads alive, 24/24 served and every token within 1e-3 of the full
   forward's argmax.  (b) A kill: ``HOROVOD_CHAOS=kill`` of rank 1 at
   step 20's completions allgather, requests in flight: rank 0 converges
   on the confirmed-dead set {1}, shrinks to a world of one and serves
   on under generation 1 (``serve.*.g1``): served plus lost must equal
   offered, nothing may expire, the requests still queued at the kill
   must be admitted and served under generation 1 (at least one of
   them), every token it served stays within 1e-3
   of the full forward's argmax, and the line gives the time from the
   kill (rank 1 stamps the moment) to the end of the first step after
   the shrink.  (c) A freeze of rank 1 for 30 s at step 10's allgather
   under a 2.5 s SLO: the heartbeat goes on beating, so rank 0 must
   convert at the in-flight deadline (under it plus one poll interval,
   and under the fault timeout; the conversion is stamped where the
   serve loop takes the error), suspicion alone must re-raise
   ``RanksFailedError`` out of ``serve_loop`` (no shrink), rank 0's flight
   dump's last dispatch names a ``serve.*.g0`` op, and one fault window
   later rank 1 must still be a suspect, not confirmed dead; the thawed
   rank 1 then sees an error or shrinks past rank 0.  (d) The
   reference's four batteries on the host planes
   (``tests/torch_resilience_worker.py``, CPU tensors, CUDA hidden): a
   kill at 4 ranks (``RanksFailedError`` naming rank 2 on every
   survivor), the retry at 4 (exact after a rebuild), a freeze at 2 and
   the off mode at 2, each time to the error printed (the four worlds
   at once; each line's ``wall_s`` counts from their common start).

14. elastic: the launcher and elastic training, one line a leg.  (a)
   ``python -m horovod_tpu_torch.runner.launch -np 1 -H localhost:1``
   starts ``chip_smoke.py --launch-worker static``: ``hvd.init()`` from
   the launcher's environment, then gpt_small at full width through
   ``DistributedOptimizer(AdamW(3e-4, wd 1e-4), compression=bf16)`` on
   cuda:0 as the binding phase trains it (2 warm-up and 5 timed steps):
   launch to the end of the first step, the mean step beside the binding
   phase's, the flash launches a step (12 of each).  (b) The elastic
   launcher (``--min-np 1 --max-np 1 -H localhost:1``) starts
   ``--launch-worker elastic``: gpt_small under ``hvd.elastic.run`` over
   ``TorchState(model, optimizer, step=0)``, 8 steps on 8 seeded
   batches, a commit after each, every step's gradients through the core
   as one grouped allreduce on the bf16 wire (``_exchange_grads``: the
   hooks' work at more ranks).  Twice: unbroken, with the chaos engine
   armed but never firing, which gives the response index ``k`` of step
   4's exchange and, from 8 more steps in the same process without the
   elastic loop, the spread of two unbroken runs; then under
   ``HOROVOD_CHAOS=fail:op=<k>,rank=*``: the exchange fails, the loop
   restores step 3's commit, shuts the core down, re-rendezvouses
   through the driver at epoch 2, syncs (``broadcast_parameters``,
   ``broadcast_optimizer_state``) and resumes.  The losses of steps 1-8
   and the parameters after step 8 (a SHA-256 of their bytes) must equal
   the unbroken run's bit for bit (within the unbroken spread if two
   unbroken runs differ), and every forward/backward pass launch each
   flash kernel 12 times: commit ms and bytes, restore ms, fault to the
   end of the first resumed step, the re-rendezvous, the epochs.  (c)
   The host scenarios of ``tests/test_torch_elastic_integration.py``
   (``tests/torch_elastic_worker.py`` ``run_scenario``: happy, a node
   failure, a grow through a discovery script, ``HOROVOD_ON_FAILURE=
   shrink`` with a chaos kill at 3 ranks, ``hvd.run`` under the driver;
   CPU tensors, CUDA hidden), the five worlds at once, beside (b)'s
   unbroken run: each world's wall time and its fault to recovery.  Any
   leg that fails fails the phase.

15. parallel: sequence and expert parallelism, one line a leg, gpt_small
   at full width (bf16, the bf16 wire, AdamW(3e-4, wd 1e-4), 2 warm-up
   and 3 timed steps a leg) over a one-rank NCCL group on a mesh of
   ``build_mesh(sp=1)``, each leg's step ms, peak memory, losses and
   flash launches.  (a) ``attention="ulysses"`` (B=8, T=2048) beside
   ``attention="flash"`` on the same batch: the losses must be bitwise
   equal and each flash kernel launch 12 times a step through
   ``_bthd_attn_adapter``.  (b) ``attention="ring"`` (local attention in
   fp32) beside ``attention="dense"`` at B=2 (fp32 scores at B=8 would
   need about 60 GB): losses within ``PARALLEL_LOSS_TOL``, no flash
   launch.  (c) ``moe_experts=8`` with flash attention (B=4, T=1024) in
   the manual and the pure-GSPMD step: finite, falling and bitwise equal
   losses, 12 launches of each kernel a step; and one fp32 MoE layer at
   gpt_small's width on the card against the same weights on the CPU
   (1e-4 of max|ref|).  (d) With n >= 2 cards, ``--parallel-card-worker``
   ranks, one a card over NCCL: (a) and (b) at sp=n (each rank its
   sequence chunk, sync over sp) and (c) at ep=n in the pure-GSPMD step
   (each rank its row block), losses equal on every rank and within
   ``PARALLEL_LOSS_TOL`` of the one-card legs'; on one card the line
   says "not run"; with cards, (c)'s pure-GSPMD step also runs with
   every block checkpointed (``remat``) at ep=n.  (e) (c)'s pure-GSPMD
   step with every block checkpointed, under each remat policy: every
   block call, the recompute on autograd's device thread included, runs
   inside the step's global view, flash_fwd launches 24 times a step and
   the backward kernels 12, and the losses lie within
   ``PARALLEL_LOSS_TOL`` of (c)'s.  The kernels line's
   ``parallel_launches`` are leg (a)'s.

16. fit: the fit loop and its state on gpt_small as the train phase
   trains it (flash, B=8, T=2048, bf16, the bf16 wire, AdamW(3e-4, wd
   1e-4)) over a one-rank NCCL group, one line a leg.  (a)
   ``Trainer.fit`` over 64 synthetic int32 token rows through
   ``ShardedBatchLoader`` with ``AsyncDataLoaderMixin`` and
   ``prefetch_to_device(size=2)``, 2 epochs of 4 steps, with
   ``LearningRateScheduleCallback(multiplier=0.5, start_epoch=1)``,
   ``MetricAverageCallback``, ``BestModelCheckpoint`` (timed saves) and a
   recorder: losses finite and falling, the reference's callback events,
   lr 3e-4 then 1.5e-4, 12 launches of each kernel a step; ms a step
   against a plain ``Trainer.step`` loop over the same batches on the
   card, the step's wait for its batch.  (d) Two more steps inside
   ``start_profiler``/``stop_profiler``, each in
   ``profiler_annotation("fit_step")``: the trace must hold the
   annotations and CUDA kernel events of each flash kernel; its
   host-to-device copies' device ms.  (b) A fresh model and optimizer
   restored from the epoch-0 checkpoint (2.29 GB) re-run epoch 1: losses
   and parameters bitwise the unbroken run's; save, restore and digest
   ms against the host link.  (c) The same with ``optimizer_in_ring``,
   through ``save_ring_checkpoint`` and ``restore_ring_checkpoint``.
   (e) ResNet-50, fp32, B=128, ``axis_name="dp"`` beside ``None`` from
   the same weights and batch: logits (1e-4), losses, statistics (1e-5)
   and parameters after each of two SGD(0.1, 0.9) steps (the larger of
   1e-5 and the plain leg's distance to itself on images moved by one
   ulp), and both step times.  The kernels line's ``fit_launches`` are
   leg (a)'s.

17. statesync: elastic membership without a restart, one line a leg;
   every process on the one card (CUDA visible), spawned as
   ``chip_smoke.py --statesync-worker ROLE RANK SIZE PORT OUTDIR``
   against one RendezvousServer.  (a) The training grow 1 -> 2: gpt_small
   as the elastic phase's user loop trains it (flash, B=8, T=2048, bf16,
   AdamW(3e-4, wd 1e-4); the gradients averaged through
   ``hvd.grouped_allreduce``) in a world of one with a
   ``StateSyncService`` over ``checkpoint.train_state_tree``; after 3
   steps a joiner process, built on a fresh model's tree, calls
   ``join_world`` and streams the 2.29 GB image from the incumbent, which
   keeps stepping, then ``load_train_state`` puts it on the card.  The
   grown world takes 3 steps, its gradients averaged through host copies
   over the TCP ring (two ranks on one card form no device plane, and
   the core refuses their CUDA tensors).  Checks: no failed step, the
   joiner's image digest equal to the stamp, ``allgather_object`` of
   ``state_digest`` one value after the grow and after every grown step,
   finite losses, 12 launches of each flash kernel a step on each rank,
   the flight events in order.  It reports the catch-up ms, bytes and
   GB/s, the two boundary stalls and their snapshots' ms, the step ms
   before and during the donation, announce to the joiner's first step,
   and the grown world's step ms and plane.  (b) Preemption 2 -> 1 under
   ``HOROVOD_PREEMPT_GRACE_S``: ``HOROVOD_CHAOS=preempt`` sends the joiner
   SIGTERM at its third grown step's digest exchange; it departs at the
   next boundary with its ``bye|`` stamp and exits 0, the incumbent
   shrinks proactively (no ``RanksFailedError``, no failed rank), its
   core forms its plane on the card again at one rank, and 3 more steps
   run at 12/12/12; SIGTERM to the survivor's first step.  (c) The
   serving grow 2 -> 3: two fp32 gpt_small ranks (the resilience phase's
   serving workload, parameters the seed's plus 0.25) with
   ``static_state=True``; a joiner runs ``join_serving_world`` once 8 of
   the first wave's 24 requests are served, streams 762 MB and checks
   them against the seed's plus 0.25; the grown world serves a second
   wave of 12.  Served equals offered, none lost or expired, one grow
   2 -> 3; ``goodput_phases`` and the catch-up.  (d) Disaggregated
   prefill: two bf16 gpt_small ranks, paged, ``prefill_ranks=1``, 16
   distinct prompts of 64-512 tokens: every prompt prefilled on rank 1
   and streamed, no fallback, all served, and rank 0's streams equal a
   colocated one-rank paged run's in this process (where one parts, each
   token within 1e-3 of the full forward's argmax); KV bytes a request
   and a token, stream ms a MB, time to first token beside the colocated
   run's.  The kernels line's ``statesync_launches`` are leg (a)'s
   incumbent's over all its steps.

18. cards: the data-parallel main path across the cards of this host,
   one line a leg.  Every rank is a process the port's launcher starts
   (``python -m horovod_tpu_torch.runner.launch -np n -H localhost:n
   chip_smoke.py --cards-worker ...``, the ``horovodrun-tpu-torch``
   program); each calls ``hvd.init()`` and then
   ``torch.cuda.set_device(hvd.local_rank())``, as upstream asks of its
   torch users, and at n > 1 fails unless the NCCL plane formed.  First
   the one-card references on card 0 over a one-rank NCCL group: gpt_small
   at B=8 as the train phase trains it (its losses must be the train
   phase's bit for bit when that phase ran).  Then a launcher world of one
   rank: the same steps through ``hvd.init`` and ``Trainer`` (losses
   within ``CARDS_LOSS_TOL`` of the reference's; the kernels line's
   ``cards_launches`` are its).  With n >= 2 cards, more references on
   card 0 (the int8, uint4 and ring wires at B=8, ResNet-50 in bf16 at
   B=128, fp32 ResNet-50 at B=128 with plain BatchNorm, on its images and
   on them moved by one ulp), then one world of n ranks, one a card,
   running in order: (1i) gpt_small's ``Trainer.step`` at dp=n, B=8/n a
   rank, on the reference's global batch for 3 steps (losses within
   ``CARDS_FIRST_LOSS_TOL`` at the first step and ``CARDS_LOSS_TOL``
   after, the parameters' SHA-256 equal on every rank after every step);
   (1ii) B=8 a rank, 2 warm-up and 5 timed steps (step ms, tokens/s a
   card, scaling against one card, the sync alone, peak memory, 12
   launches of each flash kernel a step on every rank, a profiled step);
   (2) the int8, uint4 and ring wires (sync ms, the bytes a rank sends
   beside the bf16 wire's, optimizer-state bytes a rank, losses within
   the larger of ``CARDS_LOSS_TOL`` and the wire's one-card distance
   from the bf16 leg's); (3) ResNet-50 in bf16 at B=128 a card (scaling,
   a profiled step) and in fp32 with cross-replica BatchNorm at 128/n a
   card against one card at B=128 (logits 1e-4, statistics 1e-5,
   parameters within the larger of 1e-5 and the one-ulp sensitivity);
   the quiet leg, (1ii) and (3)'s bf16 steps again with
   ``HOROVOD_CYCLE_TIME`` at ``CARDS_QUIET_CYCLE_MS`` (the eager core's
   idle negotiation's cost to the Trainer); (4) ``NcclBackend`` at n ranks in the binding phase's 11 dtypes,
   bitwise against the same collectives computed on the host, a fused
   allreduce's GB/s and bus bandwidth beside NCCL's own all-reduce, and
   device responses on 1, 2 and 4 streams; (5) binding leg (a)'s user loop
   at n ranks (its ranks' mean loss against (1ii)'s, step ms beside it,
   responses and fused bytes a step) and ``_SyncBatchNormFn`` against
   ``F.batch_norm`` on the whole batch.  Every rank's parameters,
   optimizer state and batch must lie on its own card.  Then
   ``_reduce_two_cards`` and the statesync phase's legs with each process
   on a card of its own: (a)/(b) (the grown world on the NCCL plane), (d)
   and, with three cards, (c) and (e), a training grow 2 -> 3 whose two
   incumbents share the bulk round.  The world line gives NCCL's
   transports and link types (``NCCL_DEBUG=INFO``); the first line the
   cards' names, power limits, ``nvidia-smi topo -m`` and ``nvlink
   --status``.  On one card every n-card leg says "not
   run".
19. shard: sharded parameters (``Trainer(param_rules=...)``).  On card 0
   over a one-rank NCCL group: gpt_small's flax view validated against
   the reference's canonical tensor-parallel table (no problem), the
   Trainer with that table on a mesh of one bit for bit the plain step
   over 7 steps (the kernels line's ``shard_launches`` are its), the tp
   path (the split layers over a group of one) bit for bit the plain
   pure-GSPMD step, and a checkpoint round trip.  With four cards, one
   launcher world of four ranks (``--shard-worker DIR``, the eager core
   at a 1 s cycle), in order: (a) pure-GSPMD tp=4 at B=8 on every rank,
   attention on 3 heads a rank through the flash kernels (losses within
   ``CARDS_FIRST_LOSS_TOL`` / ``CARDS_LOSS_TOL`` of the one-card leg's,
   12 launches of each kernel a step on every rank, each kernel held
   against its plain version at that shape, the bytes of parameters and
   AdamW state a rank equal to the reckoning, peak memory, step ms, the
   split's all-reduces timed alone, a profiled step); (b) manual dp=2 x
   tp=2 and (c) manual fsdp=4, each bit for bit the same mesh without
   rules (for (c) dp=4, the cards phase's parity leg); (d) MoE at ep=4
   with the experts held over ep against every rank holding them all;
   (e) ResNet-50 in bf16 with the reference's head table at dp=2 x tp=2,
   bit for bit without it; (f) (a)'s state, saved at tp=4, restored at
   dp=4 (the whole state's SHA-256 equal).  On fewer cards the world's
   line says "not run".
20. perf: perfscope, the MFU gauges and the offline tools, under
   ``HOROVOD_METRICS=on``, last.  The peak is the port's table's for the
   card (``telemetry/perfmodel.py``, the one ``bound`` reads): a card the
   table does not list fails.  (a) gpt_small's ``Trainer.step`` as the
   train phase runs it (B=8, T=2048, bf16, the bf16 wire, 2 warm-up and
   5 timed steps): ``horovod_train_step_flops`` must be
   ``transformer_train_flops`` with the LM head (2.0586e13), the
   ``horovod_train_mfu`` gauge of the timed steps within 10 % of the MFU
   of the phase's synchronised steps, 12 launches of each flash kernel a
   step, each kernel within ``kernel_error`` of its plain version at that
   shape.  (b) ResNet-50 in bf16 at B=128, 3 steps (``cudnn.benchmark``
   off: its autotuning would take most of the phase): the FLOPs gauge
   3 x 128 x ``resnet_forward_flops`` (2.9629e12).  (c) One gpt_small
   replica in bf16 (a world of one): a first wave of 2 requests, then 8
   requests of 17 new tokens, about 16 decode steps: the three serve
   gauges set, tokens/s within 25 % of the wave's decoded tokens over the
   host time of its steps after the first (the first prefills every
   prompt), FLOPs a token within the wave's contexts, MFU their product
   over the peak.  (d) ``tests/torch_perfscope_worker.py`` in a launcher world
   of four ranks on CPU tensors (CUDA hidden) with
   ``HOROVOD_METRICS_FILE`` and ``HOROVOD_TIMELINE``: an allreduce ladder
   of 4 KiB to 16 MiB; the dumps through ``python -m
   horovod_tpu_torch.telemetry.perf`` (its busbw rows must be the dumps'
   histograms recomputed) and ``python -m
   horovod_tpu_torch.telemetry.trace --critical-path`` (a rank and a
   phase), then ``perfcheck`` (0 against itself, 1 with a finding on a
   copy cut by half) and ``report`` (a dump and the merged trace), each
   its CLI's ``main`` in this process.  (e) With four
   cards, a launcher world of four ranks, one a card
   (``--perf-card-worker``): the eager NCCL ladder, its timeline started
   after one warm-up allreduce (the communicator's set-up), then
   gpt_small at dp=4, B=8 a card, whose gauge must count 4 x 2.0586e13
   over 4 peaks; every rank's ``NCCL_*`` span time counted as wire on the
   critical path, and the four dumps' ledger with ``nccl`` rows.  On fewer cards
   its line says "not run".  The kernels line's ``perf_launches`` are
   (a)'s.
21. controlplane: the rendezvous that survives its coordinator, last.
   Each replica pair is a primary as its own process (``python -m
   horovod_tpu_torch.runner.controlplane``, the chaos target) and a
   standby in this process over one WAL directory (the temporary
   directory when a block device holds it, else the checkout; the line
   names the mount), lease 500 ms.  (a) gpt_small (B=8, four rows a
   rank, T=2048, bf16, AdamW) in a world of two ranks on card 0
   (``--cp-worker``) that dials the seed list, with heartbeats
   (``HOROVOD_FAULT_TOLERANCE``) and a statesync service's membership
   watcher (a world of one would run neither), the gradients averaged
   through bf16 host copies (two ranks on one card form no device plane)
   over the shm plane with a 512 MiB region when ``/dev/shm`` holds it; ``HOROVOD_CHAOS=coordkill:name=ss.grads.2`` SIGKILLs the
   primary at step 3's exchange, beside an unbroken world of the same
   seed: 0 failed steps, losses and parameters bitwise the unbroken
   world's, kill to promotion, the longest step against the median, the
   standby's ``horovod_rendezvous_*`` counters, its ``kv_digest()``
   equal to ``replay_state`` of the log, 12 launches of each flash
   kernel a step.  (b) At the same time, ``coordpause`` through the
   port's chaos engine stops another primary for 2 s: the standby
   promotes, the resumed primary demotes and answers 409 naming it, no
   acknowledged write is lost.  (e) Also at the same time,
   ``horovodrun-tpu-torch --use-mpi -np 1`` through a stub ``mpirun``
   (``OMPI_COMM_WORLD_*``) starts the elastic phase's static worker
   (B=8): the identity adopted from those and the exported layout,
   launch to the first step.  (c) Then the WAL's cost: 64 stamps in one
   ``put_many``, 64 writer threads of 8 puts at once (each batch's fsync
   timed), a put's latency against the in-memory server.  (d)
   With four cards (``--phases controlplane-cards`` runs it alone):
   three gpt_small ranks on cards 0-2 over the NCCL plane and the
   replica set, the primary SIGKILLed at their second exchange, then a
   joiner on card 3 grows the world 3 -> 4 through the promoted standby
   (the statesync phase's roles, ``cp3``); parameters equal on every
   rank, the digest the log's.  On fewer cards its line says "not run".
   The kernels line's ``controlplane_launches`` are (a)'s rank 0's.

A line ``{"phase": "total"}`` gives the script's wall time, a line
``{"kernels": [...]}`` sums up the kernels, and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line; so does a machine without a CUDA card.

    python3 chip_smoke.py --phases train,eager

runs the device and build phases and then only the phases named, and
prints neither the kernels line nor the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import io
import json
import math
import os
import random
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

# H100 SXM device-memory bandwidth (NVIDIA data sheet), at the full 700 W
# power limit.  The dense bf16 rate is the port's own table's
# (peak_bf16_flops).
PEAK_BYTES_PER_S = 3.35e12

MAIN_SHAPE = dict(b=8, h=12, tq=2048, tk=2048, d=64, causal=True)
SIDE_SHAPE = dict(b=2, h=12, tq=1024, tk=2048, d=64, causal=False)
KERNEL_SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:70",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:177",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:225",
}
WARMUP_STEPS, TIMED_STEPS = 2, 5
# The train phase's remat legs, after the main leg (which runs without).
REMAT_POLICIES = ("full", "dots")
# _profile: the spin kernels that open a trace, idle host time on each
# side of the traced call, and how many traces it takes before it gives
# up on one that holds no kernel.
PROFILE_WARMUP = 64
PROFILE_PAD_S = 0.05
PROFILE_ATTEMPTS = 3
# Kernel names of the profile, by what they do (first match wins).
KERNEL_CATEGORIES = (
    ("flash attention (this repo)", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                     "flash_bwd_dkv_kernel")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("softmax cross entropy", ("SoftMax", "softmax", "nll_loss")),
    ("optimizer", ("multi_tensor_apply",)),
    ("nccl", ("nccl",)),
    ("reductions", ("reduce_kernel",)),
)
# The serve step's kernels: no flash kernel, the KV cache's writes and
# the paged gather are index kernels.
SERVE_CATEGORIES = (
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("KV cache writes and gathers (index_put, index)", ("index",)),
    ("softmax", ("softmax", "SoftMax")),
    ("reductions (argmax, RMSNorm mean)", ("reduce_kernel",)),
)
# The serve phase's legs: the fp32 check, then the timed bf16 legs;
# prompts are drawn from a pool, so the paged legs reuse prefixes.
SERVE_CHECK = dict(cfg=dict(max_batch=4, token_budget=1024, max_seq=1024,
                            block_tokens=16, slo_ms=600000.0),
                   requests=12, pool=4, prompt_tokens=(32, 384),
                   max_new=16, seed=5)
SERVE_TIMED = dict(cfg=dict(max_batch=8, token_budget=1024, max_seq=1024,
                            block_tokens=16, slo_ms=600000.0),
                   requests=32, pool=8, prompt_tokens=(64, 512),
                   max_new=64, seed=6)
NEAR_ARGMAX = 1e-3
# The cnn phase: the reference benchmark's batch a card (bench.py's
# --batch-size) and its models; (leg, preset, image size, warm-up steps,
# timed steps).  bench.py runs 3 warm-up and 20 timed steps.  The step
# after cuDNN's autotuning one still carries a warm-up cost (on an H100:
# 65-432 ms against 37-76 for ResNet-50, 193-580 against 66-109 for
# Inception V3, 54-93 against 53 for VGG-16), so every leg warms up for
# two steps.
CNN_BATCH = 128
CNN_LEGS = (("resnet50", "ResNet50", 224, 2, 5),
            ("vgg16", "VGG16", 224, 2, 3),
            ("inception3", "InceptionV3", 299, 2, 3))
CNN_LOGITS_REL, CNN_STATS_TOL, CNN_PARAMS_TOL = 1e-4, 1e-5, 1e-5
# A CNN step's kernels by what they do (first match wins: cuDNN's own
# BatchNorm and transpose kernels also carry "cudnn" in their names).
CNN_CATEGORIES = (
    ("flash attention (this repo)", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                     "flash_bwd_dkv_kernel")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw", "BatchNorm")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit",
                             "convolve", "conv2d", "cudnn")),
    ("GEMM kernels (cuDNN's 1x1 convolutions, the Dense layers)",
     ("nvjet", "gemm", "gemv", "xmma", "cutlass")),
    ("pooling", ("max_pool", "avg_pool", "MaxPool", "AvgPool")),
    ("optimizer", ("multi_tensor_apply",)),
    ("all-reduce and copies (NCCL, bucket cat, dtype casts)",
     ("nccl", "CatArrayBatchedCopy", "copy")),
    ("softmax cross entropy", ("SoftMax", "softmax", "nll_loss")),
    ("reductions", ("reduce_kernel",)),
)
# The sync phase: the codec leg's bucket (64 MiB of wire at 1 byte an
# element), its block, and the legs (leg, model, GradSyncConfig keywords).
SYNC_BUCKET = 64 << 20
SYNC_BLOCK = 256
SYNC_STEPS = (2, 3)                     # warm-up, timed
SYNC_GPT_LEGS = (
    ("bf16", dict(compression="bf16")),
    ("int8", dict(compression="int8")),
    ("uint4", dict(compression="uint4")),
    ("adasum-bf16", dict(op="adasum", compression="bf16")),
    ("ring-bf16", dict(compression="bf16", optimizer_in_ring=True)),
    ("ring-int8", dict(compression="int8", optimizer_in_ring=True)))
SYNC_RESNET_LEGS = (
    ("int8", dict(compression="int8")),
    ("ring", dict(compression="bf16", optimizer_in_ring=True)))
# The int8 sync's kernels by what they do (first match wins).
SYNC_CATEGORIES = (
    ("nccl (all-to-all, all-gather)", ("nccl",)),
    ("reductions (block min and max, the row sum)", ("reduce_kernel",)),
    ("copies (pack, pad, unpack, casts)", ("copy", "CatArrayBatchedCopy")),
)
# bench.py's serve leg (bench_serve's loadgen arguments).
BENCH_SERVE_ARGS = ["--requests", "96", "--duration", "5", "--rate", "120",
                    "--max-new-tokens", "4", "--prompt-tokens", "8",
                    "--profile", "burst", "--prompt-pool", "6",
                    "--max-batch", "4", "--slo-ms", "400"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, calls: int = 1, rounds: int = 20, warmup: int = 3) -> float:
    """Time of one call of ``fn`` on the card, by CUDA events: ``calls``
    calls between two events, the median over ``rounds`` of the mean.
    With one call (the default) the time also holds the host's launch
    path; with 20 queued back to back the card never waits for the host,
    so it is the device time the kernel takes inside a step."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


DEVICE = dict(calls=20, rounds=5)   # time_ms's device-time setting


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes for these lengths."""
    if not causal:
        return tq * tk
    offset = tk - tq
    return sum(min(tk, i + offset + 1) for i in range(tq))


def bound(name: str, bh: int, tq: int, tk: int, d: int, causal: bool):
    """Least time (ms) for the kernel's work on an H100, and what sets it:
    its operations at the bf16 tensor-core peak, or its bytes (each input
    read once, each output written once) at the memory rate."""
    pairs = bh * visible_pairs(tq, tk, causal)
    row_q, row_k, stat = bh * tq * d * 2, bh * tk * d * 2, bh * tq * 4
    if name == "flash_fwd":       # s = q.k^T, o = p.v
        flops = 4 * d * pairs
        nbytes = row_q + 2 * row_k + row_q + stat
    elif name == "flash_bwd_dq":  # s, dp = do.v^T, dq = ds.k
        flops = 6 * d * pairs
        nbytes = 2 * row_q + 2 * row_k + 2 * stat + row_q
    else:                         # s, dp, dv = p^T.do, dk = ds^T.q
        flops = 8 * d * pairs
        nbytes = 2 * row_q + 2 * row_k + 2 * stat + 2 * row_k
    t_ops = flops / peak_bf16_flops() * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def phase_device() -> dict:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return info


def phase_build() -> None:
    """Build the kernels and show what was compiled: per kernel instance,
    ptxas's registers and spill bytes beside the counts of the SASS
    opcodes that show the Hopper design (HGMMA = wgmma, TMA = UTMALDG or
    UBLKCP loads, HMMA = mma.sync, SYNCS = mbarrier operations)."""
    from horovod_tpu_torch.ops import _build
    _build.LIBRARY.load()
    usage = _build.ptxas_usage(_build.LIBRARY.ptxas_log)
    sass = _build.sass_counts(_build.disassemble(_build.LIBRARY.path))
    kernels = {name: {**usage.get(name, {}), **sass.get(name, {})}
               for name in sorted(set(usage) | set(sass))}
    warnings = [line.strip() for line in _build.LIBRARY.ptxas_log.splitlines()
                if "warning" in line.lower()]
    emit({"phase": "build", "build_s": _build.LIBRARY.build_seconds,
          "kernels": kernels, "ptxas_warnings": warnings})
    problems = build_problems(kernels)
    if problems:
        raise RuntimeError("; ".join(problems))


def build_problems(kernels: dict[str, dict[str, int]]) -> list[str]:
    """What is wrong with the build, from the build phase's counts per
    kernel instance: every flash kernel must show wgmma (HGMMA) and TMA
    loads and no mma.sync (HMMA), nothing may spill, and all 24 instances
    (3 kernels x 2 types x 4 head dims) must be there."""
    problems = []
    for name, k in kernels.items():
        if k.get("spill_bytes"):
            problems.append(f"{name} spills {k['spill_bytes']} bytes")
        if "registers" not in k:
            problems.append(f"ptxas reported no registers for {name}")
        if name.startswith("flash_"):
            if not (k.get("HGMMA") and k.get("TMA")):
                problems.append(f"{name} has no wgmma or no TMA load in its "
                                f"SASS")
            if k.get("HMMA", 0) != 0:
                problems.append(f"{name} has {k['HMMA']} mma.sync (HMMA)")
    if len(kernels) != 24:
        problems.append(f"{len(kernels)} kernel instances, not 24")
    return problems


def _inputs(shape: dict, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bh = shape["b"] * shape["h"]

    def rnd(t):
        return torch.randn(bh, t, shape["d"], device="cuda",
                           dtype=torch.bfloat16, generator=gen)
    return rnd(shape["tq"]), rnd(shape["tk"]), rnd(shape["tk"]), \
        rnd(shape["tq"])


def check_kernels(shape: dict, seed: int, measure: bool) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _inputs(shape, seed)
    d, causal = shape["d"], shape["causal"]
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                            causal)
    torch.cuda.synchronize()
    results = {}
    checks = {"flash_fwd": [("o", o, o_ref)],
              "flash_bwd_dq": [("dq", dq, dq_ref)],
              "flash_bwd_dkv": [("dk", dk, dk_ref), ("dv", dv, dv_ref)]}
    for name, outs in checks.items():
        # Per element: 2u|ref| + 4u rms(ref row) + u/16 mean|ref|, with
        # u = 2^-8 (bf16); see kernel_error.  "worst" is the largest
        # error over its limit.
        errs = {label: fa.kernel_error(a, b) for label, a, b in outs}
        ok = all(e["ok"] for e in errs.values())
        if name == "flash_fwd":
            # lse is fp32 on both sides; the kernel's exp is ex2.approx.
            err = (lse - lse_ref).abs().max().item()
            errs["lse"] = {"max_abs_err": err, "tol": 1e-3}
            ok = ok and err <= 1e-3
        results[name] = {"errs": errs, "ok": ok,
                         "max_abs_err": max(e["max_abs_err"]
                                            for lbl, e in errs.items()
                                            if lbl != "lse")}
    del o_ref, lse_ref, dq_ref, dk_ref, dv_ref

    bh = shape["b"] * shape["h"]
    for name in results:
        t_bound, by, flops, nbytes = bound(name, bh, shape["tq"],
                                           shape["tk"], d, causal)
        results[name].update(bound_ms=t_bound, bound_us=t_bound * 1e3,
                             bound_by=by, flops=flops, bytes=nbytes)
    if measure:
        kernel = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, causal),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                    scale, causal),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta, scale, causal),
        }
        plain = {
            "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, scale, causal),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(
                q, k, v, do, lse, delta, scale, causal),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, scale, causal),
        }
        lib = _library_times(q, k, v, do, shape)
        for name in results:
            results[name]["ms"] = time_ms(kernel[name])
            results[name]["device_ms"] = time_ms(kernel[name], **DEVICE)
            results[name]["plain_ms"] = time_ms(plain[name], rounds=10)
            which = "fwd" if name == "flash_fwd" else "bwd"
            results[name]["library_ms"] = lib[which]
            results[name]["library_device_ms"] = lib[which + "_device"]
            results[name]["library_call"] = (
                "scaled_dot_product_attention forward" if which == "fwd"
                else "scaled_dot_product_attention backward "
                     "(dq, dk and dv together)")
    return results


def _library_times(q, k, v, do, shape):
    """scaled_dot_product_attention on the same inputs ([B, H, T, D]),
    forward and backward: a yardstick only, never called by the port."""
    import torch.nn.functional as F
    b, h = shape["b"], shape["h"]

    def bhtd(x):
        return x.view(b, h, x.shape[1], x.shape[2]).detach()
    qs, ks, vs = (bhtd(x).requires_grad_() for x in (q, k, v))
    dos = bhtd(do)
    out = F.scaled_dot_product_attention(qs, ks, vs,
                                         is_causal=shape["causal"])
    calls = {"fwd": lambda: F.scaled_dot_product_attention(
                 qs, ks, vs, is_causal=shape["causal"]),
             "bwd": lambda: torch.autograd.grad(
                 out, (qs, ks, vs), dos, retain_graph=True)}
    times = {}
    for which, fn in calls.items():
        times[which] = time_ms(fn)
        times[which + "_device"] = time_ms(fn, **DEVICE)
    return times


def phase_kernels() -> dict:
    main = check_kernels(MAIN_SHAPE, seed=1, measure=True)
    emit({"phase": "kernels", "shape": MAIN_SHAPE, "results": main})
    side = check_kernels(SIDE_SHAPE, seed=2, measure=False)
    emit({"phase": "kernels", "shape": SIDE_SHAPE, "results": side})
    bad = [n for r in (main, side) for n, v in r.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    torch.cuda.empty_cache()
    return main


def phase_reference() -> None:
    """gpt_tiny on the card: flash attention (the kernels at D=16) against
    dense attention with the same weights."""
    from horovod_tpu_torch import TransformerLM, gpt_tiny
    from horovod_tpu_torch.training import cross_entropy_loss
    tokens = torch.randint(0, 256, (2, 129), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    flash = TransformerLM(gpt_tiny(attention="flash"), seed=4)
    dense = TransformerLM(gpt_tiny(attention="dense"), seed=4)
    logits_f = flash(tokens[:, :-1], train=True)
    logits_d = dense(tokens[:, :-1], train=True)
    loss_f = cross_entropy_loss(logits_f, tokens[:, 1:])
    loss_d = cross_entropy_loss(logits_d, tokens[:, 1:])
    loss_f.backward()
    loss_d.backward()
    err = (logits_f.float() - logits_d.float()).abs()
    grad_err = max((pf.grad - pd.grad).abs().max().item()
                   for pf, pd in zip(flash.parameters(), dense.parameters()))
    out = {"phase": "reference", "logits_shape": list(logits_f.shape),
           "logits_max_abs_err": err.max().item(),
           "logits_mean_abs_err": err.mean().item(),
           "loss_flash": loss_f.item(), "loss_dense": loss_d.item(),
           "grad_max_abs_err": grad_err}
    emit(out)
    # bf16 logits of order 1: a few ulps (0.0078 each) where the two
    # attentions round differently; the fp32 losses agree to 1e-2.
    if not (torch.isfinite(logits_f).all() and out["logits_max_abs_err"] < 0.1
            and out["logits_mean_abs_err"] < 1.5e-2
            and abs(out["loss_flash"] - out["loss_dense"]) < 1e-2
            and grad_err < 5e-2):
        raise RuntimeError(f"flash and dense gpt_tiny disagree: {out}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _one_rank_nccl():
    """A NCCL process group of one rank on card 0, for the Trainer's
    all-reduces; destroyed on the way out."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, is_master=True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def phase_train() -> dict:
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_small,
                                   synthetic_text_batch)
    from horovod_tpu_torch.ops import flash_attention as fa

    with _one_rank_nccl() as dist:
        cfg = gpt_small(attention="flash", max_seq_len=2048)
        model = TransformerLM(cfg, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        trainer = Trainer(model, opt, build_mesh(dp=1),
                          sync=GradSyncConfig(op="average",
                                              compression="bf16"))
        batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
        state = trainer.init(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        fa.reset_launch_counts()                 # the main path starts
        losses, step_ms = [], []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        launches = fa.launch_counts()            # ... and ends
        steps = WARMUP_STEPS + TIMED_STEPS

        timed = step_ms[WARMUP_STEPS:]
        mean_ms = statistics.mean(timed)
        tokens = 8 * 2048
        out = {"phase": "train", "model": "gpt_small", "params": n_params,
               "batch": 8, "seq": 2048, "dtype": "bfloat16",
               "wire": "bf16", "backend": dist.get_backend(),
               "losses": losses, "step_ms": step_ms,
               "timed_step_ms_mean": mean_ms,
               "timed_step_ms_median": statistics.median(timed),
               "tokens_per_s": tokens / (mean_ms / 1e3),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "launches_per_step": {n: c / steps
                                     for n, c in launches.items()},
               "accuracy": metrics["accuracy"].item()}
        emit(out)
        problems = []
        if not all(math.isfinite(x) for x in losses):
            problems.append("a loss is not finite")
        if not losses[-1] < losses[0]:
            problems.append("the loss did not fall")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
            problems.append("the first loss is far from ln(vocab)")
        for name, count in launches.items():
            if count != cfg.num_layers * steps:
                problems.append(f"{name} launched {count} times, not "
                                f"{cfg.num_layers} a step")
        if problems:
            raise RuntimeError("; ".join(problems))
        out["profile"] = _profile(lambda: trainer.step(state, batch),
                                  mean_ms)
        emit({"phase": "profile", **out["profile"]})
        del trainer, state, opt, model
        torch.cuda.empty_cache()
        legs = {"none": {"timed_step_ms_mean": mean_ms,
                         "peak_memory_bytes": out["peak_memory_bytes"],
                         "profile": out["profile"]}}
        for policy in REMAT_POLICIES:
            legs[policy] = _remat_leg(policy, batch)
        emit({"phase": "train", "leg": "remat-summary",
              **{key: {k: v[key] for k, v in legs.items()}
                 for key in ("timed_step_ms_mean", "peak_memory_bytes")},
              **{key: {k: v["profile"][key] for k, v in legs.items()}
                 for key in ("kernel_ms", "device_idle_share",
                             "kernel_launches")}})
        return out


def _remat_leg(policy: str, batch: dict) -> dict:
    """gpt_small as the main leg trains it, with each block checkpointed
    under ``remat_policy``: step ms, peak memory, losses and the flash
    launches by kernel.  A checkpointed block runs its forward twice, so
    a step launches the forward kernel 24 times and dq and dK/dV 12."""
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_small)
    from horovod_tpu_torch.ops import flash_attention as fa

    cfg = gpt_small(attention="flash", max_seq_len=2048, remat=True,
                    remat_policy=policy)
    model = TransformerLM(cfg, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    trainer = Trainer(model, opt, build_mesh(dp=1),
                      sync=GradSyncConfig(op="average", compression="bf16"))
    state = trainer.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, step_ms = [], []
    steps = WARMUP_STEPS + TIMED_STEPS
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = fa.launch_counts()
    out = {"phase": "train", "leg": f"remat-{policy}", "model": "gpt_small",
           "batch": 8, "seq": 2048, "dtype": "bfloat16", "losses": losses,
           "step_ms": step_ms,
           "timed_step_ms_mean": statistics.mean(step_ms[WARMUP_STEPS:]),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()}}
    emit(out)
    out["profile"] = _profile(lambda: trainer.step(state, batch),
                              out["timed_step_ms_mean"])
    emit({"phase": "profile", "leg": f"remat-{policy}", **out["profile"]})
    want = {"flash_fwd": 2 * cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
            "flash_bwd_dkv": cfg.num_layers}
    problems = [f"remat {policy}: {name} launched {launches[name]} times, "
                f"not {per_step} a step" for name, per_step in want.items()
                if launches[name] != per_step * steps]
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"remat {policy}: a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append(f"remat {policy}: the loss did not fall")
    del trainer, state, opt, model
    torch.cuda.empty_cache()
    if problems:
        raise RuntimeError("; ".join(problems))
    return out


def _profile(fn, wall_ms: float, categories=KERNEL_CATEGORIES) -> dict:
    """Device time by kernel over one more call of ``fn``
    (torch.profiler): kernel events only, their union against the span
    from the first kernel's start to the last one's end (the idle share),
    and the sum of kernel time against ``wall_ms``, the unprofiled time
    of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen: list[dict] = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # A trace after the first one of a process can lose the
            # device records at its start (a millisecond's call lost 15
            # of its 19 kernels, once all of them), and the profiler keeps
            # only device events inside its host-clock window. So the
            # trace opens with PROFILE_WARMUP spin kernels, left out of
            # the result, and idles on each side of the call.
            for _ in range(PROFILE_WARMUP):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.events()
        # Kernel events only, not the annotations the profiler also puts
        # on the device timeline ("Optimizer.step#AdamW.step"; a kernel's
        # own name may hold "#" too, as in "{lambda(int)#1}", but never
        # without a space).
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not ("#" in e.name and " " not in e.name)]
        warmup_seen = sum("spin_kernel" in e.name for e in device)
        kernels = [e for e in device if "spin_kernel" not in e.name]
        if kernels:
            break
        seen.append({"events": len(events), "device_events": len(device),
                     "warmup_seen": warmup_seen})
    else:
        raise RuntimeError(f"the profiler saw no kernel on the card in "
                           f"{PROFILE_ATTEMPTS} traces: {seen}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    window_us = spans[-1][1] - spans[0][0]
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.end - e.time_range.start
        entry[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    kernel_us = sum(v[0] for _, v in rows)
    flash_us = {n: sum(v[0] for k, v in rows if n + "_kernel" in k)
                for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # Device-to-host copies: a CUDA tensor staged through the host
    # would show as one as long as its bytes take.
    dtoh = [e.time_range.end - e.time_range.start for e in kernels
            if "DtoH" in e.name]
    # Every category is listed, 0 where no kernel fell in it.
    cats = dict.fromkeys([c for c, _ in categories]
                         + ["elementwise and other"], 0.0)
    for name, (us, _) in rows:
        cat = next((c for c, keys in categories if any(
            key in name for key in keys)), "elementwise and other")
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
    return {"kernel_ms": kernel_us / 1e3, "busy_ms": busy_us / 1e3,
            "window_ms": window_us / 1e3, "empty_traces": len(seen),
            "warmup_seen": warmup_seen,
            "device_idle_share": 1 - busy_us / window_us,
            "kernel_share_of_timed_step": kernel_us / 1e3 / wall_ms,
            "kernel_launches": sum(v[1] for _, v in rows),
            "dtoh_copies": len(dtoh), "dtoh_ms": sum(dtoh) / 1e3,
            "dtoh_max_ms": max(dtoh, default=0.0) / 1e3,
            "flash_ms": {n: us / 1e3 for n, us in flash_us.items()},
            "category_ms": cats,
            "top": [{"name": n[:100], "ms": v[0] / 1e3, "count": v[1]}
                    for n, v in rows[:25]]}


def _prompt_pool(spec: dict, vocab: int) -> list[list[int]]:
    rng = random.Random(spec["seed"])
    lo, hi = spec["prompt_tokens"]
    return [[rng.randrange(2, vocab) for _ in range(rng.randint(lo, hi))]
            for _ in range(spec["pool"])]


def _serve_leg(spec: dict, model_cfg, paged: bool, params=None) -> dict:
    """One leg of the serve phase through the entry points a user calls:
    every request queued with ``queue.submit``, then ``serve_loop`` until
    the queue and the slots are drained."""
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    ex = ReplicaExecutor(ServeConfig(model_cfg=model_cfg, paged=paged,
                                     **spec["cfg"]), params=params)
    streams: dict[int, list[int]] = {}
    collect = ex._collect_completions

    def record():
        for s in ex.slots:
            if s is not None and s.remaining == 0:
                streams[s.rid] = list(s.generated)
        collect()
    ex._collect_completions = record
    prompts = _prompt_pool(spec, model_cfg.vocab_size)
    rid_prompt = {}
    for i in range(spec["requests"]):
        prompt = prompts[i % len(prompts)]
        ex.stats["offered"] += 1
        rid_prompt[ex.queue.submit(prompt, spec["max_new"])] = prompt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex.serve_loop(stop_when=lambda: True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The recording closure and the executor refer to each other; without
    # the cycle the executor's memory is freed when the leg returns, not
    # whenever the garbage collector runs, so later legs' peaks exclude it.
    del ex._collect_completions
    lat = sorted(ex.stats["latencies_ms"])
    step = ex.admission._m_step
    tokens = sum(len(g) for g in streams.values())
    out = {"paged": paged,
           "dtype": str(model_cfg.dtype).replace("torch.", ""),
           "requests": spec["requests"], "served": ex.stats["served"],
           "wall_s": wall, "steps": ex._step, "tokens_generated": tokens,
           "tokens_per_s": tokens / wall,
           "step_ms": {"p50": step.quantile(0.5), "p99": step.quantile(0.99),
                       "count": step.count},
           "latency_ms": {"p50": lat[len(lat) // 2] if lat else 0.0,
                          "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))]
                          if lat else 0.0},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "kv": ex.kv_stats(),
           "max_concurrent_seqs": ex.batcher.max_concurrent}
    ex.close()
    return {"line": out, "streams": streams, "rid_prompt": rid_prompt}


def _near_argmax(model, streams: dict, rid_prompt: dict) -> dict:
    """Every generated token against the full forward (no cache, dense
    attention, the same weights) over prompt + generated tokens: it must
    score within NEAR_ARGMAX of the row's maximum.  Returns the counts."""
    bad, not_exact, total = [], 0, 0
    with torch.no_grad():
        for rid, gen in streams.items():
            prompt = rid_prompt[rid]
            seq = torch.tensor([prompt + gen], device="cuda")
            logits = model(seq)[0, len(prompt) - 1:len(prompt) - 1 + len(gen)]
            got = torch.tensor(gen, device="cuda")
            score = logits.gather(1, got[:, None])[:, 0]
            top = logits.max(dim=1).values
            short = (score < top - NEAR_ARGMAX).nonzero().flatten().tolist()
            bad += [(rid, j) for j in short]
            not_exact += int((logits.argmax(dim=1) != got).sum())
            total += len(gen)
    return {"tokens_checked": total, "not_exact_argmax": not_exact,
            "beyond_tolerance": bad}


def _serve_profile(model_cfg, steps: int = 8) -> dict:
    """8 dense decode steps with every slot of the batch busy: first
    timed unprofiled, then profiled."""
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    cfg = SERVE_TIMED["cfg"]
    ex = ReplicaExecutor(ServeConfig(model_cfg=model_cfg, **cfg))
    prompts = _prompt_pool(dict(SERVE_TIMED, prompt_tokens=(64, 128)),
                           model_cfg.vocab_size)
    for i in range(cfg["max_batch"]):
        ex.queue.submit(prompts[i % len(prompts)], 3 * steps + 8)
    while any(s is None for s in ex.slots):
        ex._serve_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ex._serve_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(lambda: [ex._serve_step() for _ in range(steps)],
                    wall_ms, SERVE_CATEGORIES)
    busy = sum(s is not None for s in ex.slots)
    ex.request_stop()
    ex.serve_loop()
    ex.close()
    return {"steps": steps, "batch": cfg["max_batch"], "busy_slots": busy,
            "step_ms_unprofiled": wall_ms / steps,
            "kernel_ms_per_step": prof["kernel_ms"] / steps,
            "kernel_launches_per_step": prof["kernel_launches"] / steps,
            **prof}


def phase_serve() -> dict:
    """The port's serving path on gpt_small (see the module docstring)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import TransformerLM, gpt_small
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import loadgen
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    problems = []
    # The executor's world is hvd's: a world of one, whose exchanges run
    # through the eager core.  The loadgen leg's hvd.shutdown() ends it.
    hvd.init()

    # 1. fp32 legs, each token held against the full forward.
    cfg32 = gpt_small(dtype=torch.float32)
    ref = TransformerLM(cfg32, seed=0)
    params = ref.state_dict()
    legs = {}
    for paged in (False, True):
        leg = _serve_leg(SERVE_CHECK, cfg32, paged, params)
        check = _near_argmax(ref, leg["streams"], leg["rid_prompt"])
        leg["line"]["check"] = check
        legs[paged] = leg
        if leg["line"]["served"] != SERVE_CHECK["requests"]:
            problems.append(f"fp32 {'paged' if paged else 'dense'} leg "
                            f"served {leg['line']['served']}")
        if check["beyond_tolerance"]:
            problems.append(f"tokens beyond {NEAR_ARGMAX} of the full "
                            f"forward's argmax: {check['beyond_tolerance']}")
    kv = legs[True]["line"]["kv"]
    if not (kv["active"] == 0 and kv["prefix_hits"] > 0
            and kv["cow_copies"] > 0 and kv["prefill_skipped"] > 0):
        problems.append(f"paged census: {kv}")
    differ = sum(legs[False]["streams"][r] != legs[True]["streams"].get(r)
                 for r in legs[False]["streams"])
    for paged in (False, True):
        emit({"phase": "serve", "leg": "check", **legs[paged]["line"],
              "streams_dense_vs_paged_differ": differ})
    del ref, params, legs
    torch.cuda.empty_cache()

    # 2. timed bf16 legs.
    cfg16 = gpt_small()
    timed = {paged: _serve_leg(SERVE_TIMED, cfg16, paged)
             for paged in (False, True)}
    agree = sum(timed[False]["streams"][r] == timed[True]["streams"].get(r)
                for r in timed[False]["streams"])
    for paged in (False, True):
        line = timed[paged]["line"]
        # PR 4 recorded 30-42 ms a step here with the exchanges outside
        # the core; the difference is what the core's four negotiated
        # collectives a step cost.
        emit({"phase": "serve", "leg": "timed", **line,
              "streams_dense_vs_paged_equal": agree,
              "streams": len(timed[False]["streams"]),
              "pr4_step_ms_recorded": [30, 42]})
        if line["served"] != SERVE_TIMED["requests"]:
            problems.append(f"bf16 {'paged' if paged else 'dense'} leg "
                            f"served {line['served']}")
    del timed
    torch.cuda.empty_cache()

    # 3. where a decode step's time goes.
    prof = _serve_profile(cfg16)
    emit({"phase": "serve", "leg": "profile", **prof})
    if prof["busy_slots"] != SERVE_TIMED["cfg"]["max_batch"]:
        problems.append(f"profiled {prof['busy_slots']} busy slots")

    # 4. the loadgen CLI with the reference benchmark's serve arguments.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "SERVE_r{rank}.json")
        rc = loadgen.main(BENCH_SERVE_ARGS + ["--output", out])
        with open(out.replace("{rank}", "0")) as f:
            report = json.load(f)
    emit({"phase": "serve", "leg": "loadgen", "rc": rc,
          **{k: report[k] for k in ("schema", "offered", "served", "shed",
                                    "expired", "goodput_rps", "latency_ms",
                                    "step_ms", "steps", "wall_s")}})
    if rc != 0 or report["schema"] != loadgen.SCHEMA or report["served"] <= 0:
        problems.append(f"loadgen: rc {rc}, schema {report['schema']}, "
                        f"served {report['served']}")

    launches = fa.launch_counts()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "serve", "leg": "summary", "flash_launches": launches,
          "seconds": seconds})
    if any(launches.values()):
        problems.append(f"flash kernels launched while serving: {launches}")
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| over max|ref|."""
    got, ref = got.detach().cpu().float(), ref.detach().cpu().float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _max_err(got: dict, ref: dict) -> float:
    """Largest max|got[k] - ref[k]| over the entries of ``ref``."""
    return max((got[k].detach().cpu() - v).abs().max().item()
               for k, v in ref.items())


def _cnn_cpu_reference() -> dict:
    """fp32 ResNet-50 on the CPU, before the process group exists (so that
    its Trainer's all-reduce is the identity): the initial state, one
    train-mode forward's logits and statistics, and the parameters after
    one SGD step through ``Trainer``."""
    from horovod_tpu_torch import (ResNet50, Trainer, build_mesh,
                                   synthetic_image_batch)
    model = ResNet50(dtype=torch.float32, device="cpu", seed=0)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = synthetic_image_batch(2, 224, seed=1, device="cpu")
    with torch.no_grad():
        logits = model(batch["image"], train=True)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    model.load_state_dict(state0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = Trainer(model, opt, build_mesh(device="cpu"))
    _, metrics = trainer.step(trainer.init(), batch)
    return {"state0": state0, "batch": batch, "logits": logits,
            "stats": stats, "loss": metrics["loss"].item(),
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()}}


def _cnn_check(ref: dict) -> dict:
    """The check leg on the card, against ``_cnn_cpu_reference``."""
    from horovod_tpu_torch import ResNet50, Trainer, build_mesh
    from horovod_tpu_torch.models.resnet import fold_conv7_stem_weights
    model = ResNet50(dtype=torch.float32, seed=0)
    model.load_state_dict(ref["state0"])
    batch = {k: v.cuda() for k, v in ref["batch"].items()}
    with torch.no_grad():
        logits = model(batch["image"], train=True)
    out = {"phase": "cnn", "leg": "check", "model": "ResNet50",
           "dtype": "float32", "batch": 2, "image_size": 224,
           "logits_rel_err": _rel_err(logits, ref["logits"]),
           "stats_max_abs_err": _max_err(dict(model.named_buffers()),
                                         ref["stats"])}
    # The space-to-depth stem with the conv7 weights folded, eval mode.
    model.load_state_dict(ref["state0"])
    s2d = ResNet50(dtype=torch.float32, stem="space_to_depth", seed=0)
    folded = dict(ref["state0"])
    folded["conv_init.weight"] = fold_conv7_stem_weights(
        folded["conv_init.weight"])
    s2d.load_state_dict(folded)
    with torch.no_grad():
        out["s2d_vs_conv7_rel_err"] = _rel_err(s2d(batch["image"]),
                                               model(batch["image"]))
    del s2d
    # One SGD step through the Trainer (fp32 wire, one-rank NCCL group).
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = Trainer(model, opt, build_mesh(dp=1))
    _, metrics = trainer.step(trainer.init(batch), batch)
    out.update(loss=metrics["loss"].item(), loss_cpu=ref["loss"],
               params_max_abs_err=_max_err(dict(model.named_parameters()),
                                           ref["params"]))
    emit(out)
    bounds = {"logits_rel_err": CNN_LOGITS_REL,
              "stats_max_abs_err": CNN_STATS_TOL,
              "s2d_vs_conv7_rel_err": CNN_LOGITS_REL,
              "params_max_abs_err": CNN_PARAMS_TOL}
    return {k: out[k] for k, bound in bounds.items()
            if not out[k] <= bound}


def _cnn_work(model, image_size: int) -> dict:
    """What one image costs, counted by hooks over a forward of one image:
    the FLOPs of the convolutions and Dense layers (2 per multiply-add)
    and the elements the BatchNorms normalise."""
    from horovod_tpu_torch.models import layers
    count = {"flops": 0, "bn_elements": 0}

    def conv(mod, args, out):
        count["flops"] += 2 * out.numel() * mod.weight[0].numel()

    def dense(mod, args, out):
        count["flops"] += 2 * out.numel() * mod.in_features

    def norm(mod, args, out):
        count["bn_elements"] += out.numel()
    hooks = [m.register_forward_hook(
        {layers.Conv: conv, layers.Dense: dense, layers.BatchNorm: norm}[
            type(m)]) for m in model.modules()
        if type(m) in (layers.Conv, layers.Dense, layers.BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(1, image_size, image_size, 3, device="cuda"))
    for h in hooks:
        h.remove()
    return count


def _cnn_leg(leg: str, preset: str, image_size: int, warmup: int,
             timed: int, profile: bool) -> dict:
    """One timed leg: ``Trainer.step`` in bf16 with a bf16 wire and
    SGD(0.1, momentum 0.9) on one fixed synthetic batch of CNN_BATCH."""
    import horovod_tpu_torch as hvt
    model = getattr(hvt, preset)(seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = hvt.Trainer(model, opt, hvt.build_mesh(dp=1),
                          sync=hvt.GradSyncConfig(op="average",
                                                  compression="bf16"))
    batch = hvt.synthetic_image_batch(CNN_BATCH, image_size, 1000, seed=0)
    state = trainer.init(batch)
    work = _cnn_work(model, image_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    steps = step_ms[warmup:]
    mean_ms = statistics.mean(steps)
    out = {"phase": "cnn", "leg": leg, "model": preset,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": CNN_BATCH, "image_size": image_size,
           "dtype": "bfloat16", "wire": "bf16",
           "optimizer": "SGD(lr=0.1, momentum=0.9)", "losses": losses,
           "step_ms": step_ms, "timed_step_ms_mean": mean_ms,
           "timed_step_ms_median": statistics.median(steps),
           "timed_step_ms_min": min(steps), "timed_step_ms_max": max(steps),
           "images_per_s": CNN_BATCH / (mean_ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           # Forward and backward are 3x the forward's FLOPs; BatchNorm
           # moves its bf16 activations (2 bytes) 8 times: read for the
           # statistics, read and written by the transform, x and dy read
           # for the backward reduction, x and dy read and dx written by
           # the backward elementwise pass.
           "train_flops": 3 * work["flops"] * CNN_BATCH,
           "flops_bound_ms": 3 * work["flops"] * CNN_BATCH
           / peak_bf16_flops() * 1e3,
           "bn_elements": work["bn_elements"] * CNN_BATCH,
           "bn_bytes_bound_ms": 16 * work["bn_elements"] * CNN_BATCH
           / PEAK_BYTES_PER_S * 1e3}
    if profile:
        out["profile"] = _profile(lambda: trainer.step(state, batch),
                                  mean_ms, CNN_CATEGORIES)
    emit(out)
    return out


def phase_cnn() -> dict:
    """The CNN train step (see the module docstring)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    problems = []
    ref = _cnn_cpu_reference()
    with _one_rank_nccl():
        bad = _cnn_check(ref)
        if bad:
            problems.append(f"check leg beyond its bounds: {bad}")
        del ref
        torch.backends.cudnn.benchmark = True
        try:
            legs = {}
            for leg, preset, size, warmup, timed in CNN_LEGS:
                torch.cuda.empty_cache()
                legs[leg] = _cnn_leg(leg, preset, size, warmup, timed,
                                     profile=leg == "resnet50")
        finally:
            torch.backends.cudnn.benchmark = False
    for leg, out in legs.items():
        if not all(math.isfinite(x) for x in out["losses"]):
            problems.append(f"{leg}: a loss is not finite")
    losses = legs["resnet50"]["losses"]
    if not losses[-1] < losses[0]:
        problems.append("resnet50: the loss did not fall")
    launches = fa.launch_counts()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "cnn", "leg": "summary", "flash_launches": launches,
          "seconds": seconds})
    if any(launches.values()):
        problems.append(f"flash kernels launched in the cnn phase: "
                        f"{launches}")
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"flash_launches": launches, "seconds": seconds}


def _sync_codec_leg() -> dict:
    """The codec on the card against the CPU, bitwise, and the quantized
    all-reduce of a 64 Mi-element bucket against the bf16 wire's."""
    from horovod_tpu_torch.compress import CompressionCodec
    from horovod_tpu_torch.compress import ops
    from horovod_tpu_torch.parallel import collectives
    n = SYNC_BUCKET
    gen = torch.Generator().manual_seed(11)
    cpu = torch.randn(1, n, generator=gen) * 2
    bucket = cpu.cuda()
    out = {"phase": "sync", "leg": "codec", "elements": n,
           "block": SYNC_BLOCK, "bitwise_equal": {}}
    problems = []
    for name in ("int8", "uint4"):
        codec = CompressionCodec[name.upper()]
        card = ops.quantize_rows(bucket, codec, SYNC_BLOCK)
        host = ops.quantize_rows(cpu, codec, SYNC_BLOCK)
        card_deq = ops.dequantize_rows(*card, codec, SYNC_BLOCK)
        host_deq = ops.dequantize_rows(*host, codec, SYNC_BLOCK)
        equal = {part: torch.equal(a.cpu(), b) for part, a, b in zip(
            ("payload", "scales", "zero_points", "dequantized"),
            (*card, card_deq), (*host, host_deq))}
        out["bitwise_equal"][name] = equal
        if not all(equal.values()):
            problems.append(f"{name} codec: card and CPU differ: {equal}")
        del card, host, card_deq, host_deq
    flat = bucket.view(-1)
    for name in ("int8", "uint4"):
        codec = CompressionCodec[name.upper()]
        out[f"{name}_allreduce_ms"] = time_ms(
            lambda: ops.quantized_allreduce(flat, None, "average", codec,
                                            SYNC_BLOCK), rounds=5)
    out["bf16_allreduce_ms"] = time_ms(
        lambda: collectives.allreduce(flat.to(torch.bfloat16), "average")
        .float(), rounds=5)
    # A single fused pass: read the fp32 bucket, write the fp32 result,
    # and about 2 bytes of wire between them.
    out["fused_bytes_per_element"] = 10
    out["fused_bound_ms"] = 10 * n / PEAK_BYTES_PER_S * 1e3
    out["bf16_bytes_bound_ms"] = (4 + 2 + 2 + 2 + 4) * n \
        / PEAK_BYTES_PER_S * 1e3
    emit(out)
    del bucket, flat
    torch.cuda.empty_cache()
    return {"problems": problems}


def _optimizer_bytes(opt) -> int:
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def _sync_leg(model_name: str, leg: str, sync_kw: dict) -> dict:
    """One leg: Trainer.step with this sync, 2 warm-up and 3 timed steps,
    then the sync alone on the last step's gradients."""
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import grad_sync
    from horovod_tpu_torch.parallel.grad_sync import (sync_and_apply,
                                                      sync_gradients)
    if model_name == "gpt_small":
        cfg = hvt.gpt_small(attention="flash", max_seq_len=2048)
        model = hvt.TransformerLM(cfg, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        batch = hvt.synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
        flash_per_step = cfg.num_layers
    else:
        model = hvt.ResNet50(seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        batch = hvt.synthetic_image_batch(CNN_BATCH, 224, 1000, seed=0)
        flash_per_step = 0
    sync = hvt.GradSyncConfig(**{"op": "average", **sync_kw})
    trainer = hvt.Trainer(model, opt, hvt.build_mesh(dp=1), sync=sync)
    state = trainer.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = SYNC_STEPS
    fa.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    params = {n: trainer._params[n] for n in trainer._names}
    grads = {n: p.grad for n, p in params.items()}
    if sync.optimizer_in_ring:
        sync_ms = time_ms(lambda: sync_and_apply(
            state.optimizer, grads, params, sync, None, trainer._layouts),
            rounds=5, warmup=1)
    else:
        sync_ms = time_ms(lambda: sync_gradients(
            grads, sync, None, trainer._layouts), rounds=5, warmup=1)
    extra = {}
    if model_name == "gpt_small" and leg == "int8":
        # Where the int8 sync's time goes, and what packing the gradients
        # in flax's element order costs against memory order (one read
        # and one write of 762 MB).
        extra["profile"] = _profile(lambda: sync_gradients(
            grads, sync, None, trainer._layouts), sync_ms, SYNC_CATEGORIES)
        flat = torch.empty(sum(g.numel() for g in grads.values()),
                           device="cuda")
        leaves = list(grads.values())
        layouts = [trainer._layouts[n] for n in grads]
        extra["pack_flax_order_ms"] = time_ms(
            lambda: grad_sync._pack(leaves, layouts, flat), rounds=5)
        extra["pack_memory_order_ms"] = time_ms(
            lambda: grad_sync._pack(leaves, [None] * len(leaves), flat),
            rounds=5)
        extra["pack_bytes_bound_ms"] = 8 * flat.numel() \
            / PEAK_BYTES_PER_S * 1e3
        del flat
    out = {"phase": "sync", "leg": f"{model_name}-{leg}",
           "model": model_name, "sync": sync_kw, "losses": losses,
           "step_ms": step_ms,
           "timed_step_ms_mean": statistics.mean(step_ms[warmup:]),
           "sync_ms": sync_ms, "peak_memory_bytes": peak,
           "optimizer_state_bytes": _optimizer_bytes(state.optimizer),
           "gradient_elements": sum(p.numel() for p in params.values()),
           "launches": launches, **extra}
    emit(out)
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"{out['leg']}: a loss is not finite")
    elif not losses[-1] < losses[0]:
        problems.append(f"{out['leg']}: the loss did not fall")
    steps = warmup + timed
    for name, count in launches.items():
        if count != flash_per_step * steps:
            problems.append(f"{out['leg']}: {name} launched {count} times, "
                            f"not {flash_per_step} a step")
    del trainer, model, opt, state, params, grads
    torch.cuda.empty_cache()
    return {"problems": problems, "line": out}


def phase_sync() -> dict:
    """The rest of gradient sync (see the module docstring)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    problems = []
    with _one_rank_nccl():
        problems += _sync_codec_leg()["problems"]
        legs = {}
        for leg, kw in SYNC_GPT_LEGS:
            r = _sync_leg("gpt_small", leg, kw)
            problems += r["problems"]
            legs[f"gpt_small-{leg}"] = r["line"]
        torch.backends.cudnn.benchmark = True
        try:
            for leg, kw in SYNC_RESNET_LEGS:
                r = _sync_leg("resnet50", leg, kw)
                problems += r["problems"]
                legs[f"resnet50-{leg}"] = r["line"]
        finally:
            torch.backends.cudnn.benchmark = False
    seconds = time.perf_counter() - t_phase
    emit({"phase": "sync", "leg": "summary", "seconds": seconds,
          "step_ms": {k: v["timed_step_ms_mean"] for k, v in legs.items()},
          "sync_ms": {k: v["sync_ms"] for k, v in legs.items()}})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds}


# ---------------------------------------------------------------------------
# The eager phase: worlds of the port's eager API on this machine's host
# ---------------------------------------------------------------------------
EAGER_WORLD_TIMEOUT = 240.0
EAGER_BIG_BYTES = 16 << 20
LADDER_BYTES = (4 << 10, 64 << 10, 1 << 20)
# Every dtype of the checks: name -> (torch dtype, numpy dtype of the
# expectation).
EAGER_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32, "float64": torch.float64,
                "int8": torch.int8, "uint8": torch.uint8,
                "int32": torch.int32, "int64": torch.int64}


def _eager_check(hvd, rank: int, size: int) -> list[str]:
    """The collectives battery of ``tests/mp_worker.py:17-107`` on torch
    tensors, each result against its numpy expectation; returns what
    disagreed."""
    import numpy as np
    bad: list[str] = []

    def check(tag, got, want, tol=0.0):
        g = got.float().double().numpy() if got.dtype == torch.bfloat16 \
            else got.double().numpy()
        w = np.asarray(want, dtype=np.float64)
        if g.shape != w.shape or not np.allclose(g, w, rtol=tol, atol=0):
            bad.append(f"{tag}: got {g.ravel()[:4]} want {w.ravel()[:4]}")

    x = torch.arange(16, dtype=torch.float32) + rank
    want = np.arange(16) * size + sum(range(size))
    check("ar_sum", hvd.allreduce(x, op=hvd.Sum, name="ar_sum"), want)
    check("ar_avg", hvd.allreduce(x, op=hvd.Average, name="ar_avg"),
          want / size, 1e-6)
    check("ar_scale", hvd.allreduce(torch.ones(8), op=hvd.Sum,
                                    name="ar_scale", prescale_factor=2.0,
                                    postscale_factor=0.5),
          np.full(8, float(size)))
    for tag, dt in EAGER_DTYPES.items():
        v = (torch.arange(17) % 5 + rank + 1).to(dt)
        out = hvd.allreduce(v, op=hvd.Sum, name=f"ar_{tag}")
        if out.dtype != dt:
            bad.append(f"ar_{tag}: dtype {out.dtype}")
        check(f"ar_{tag}", out, sum(np.arange(17) % 5 + r + 1
                                    for r in range(size)))
    b = torch.tensor([rank == 0, True, False])
    check("ar_bool", hvd.allreduce(b, op=hvd.Sum, name="ar_bool"),
          [1, 1, 0])
    xs = [torch.full((4,), float(rank + i)) for i in range(3)]
    for i, out in enumerate(hvd.grouped_allreduce(xs, op=hvd.Sum,
                                                  name="gar")):
        check(f"gar{i}", out, np.full(4, sum(r + i for r in range(size))))
    local = torch.full((rank + 1, 3), float(rank))
    check("ag", hvd.allgather(local, name="ag"),
          np.concatenate([np.full((r + 1, 3), r) for r in range(size)]))
    handles = [hvd.allgather_async(
        torch.full((rank + 1, i + 2), 10.0 * rank + i), name=f"burst{i}")
        for i in range(4)]
    for i, h in enumerate(handles):
        check(f"burst{i}", hvd.synchronize(h),
              np.concatenate([np.full((r + 1, i + 2), 10.0 * r + i)
                              for r in range(size)]))
    root = size - 1
    check("bc", hvd.broadcast(torch.arange(6, dtype=torch.float64)
                              * (rank + 1), root_rank=root, name="bc"),
          np.arange(6) * (root + 1))
    out, splits = hvd.alltoall(torch.arange(2 * size, dtype=torch.float32)
                               + 100 * rank, splits=[2] * size, name="a2a")
    check("a2a", out, np.concatenate([np.arange(2 * rank, 2 * rank + 2)
                                      + 100 * r for r in range(size)]))
    check("a2a_splits", splits, [2] * size)
    rs = hvd.reducescatter(torch.arange(4 * size, dtype=torch.float32)
                           .reshape(2 * size, 2) * (rank + 1), op=hvd.Sum,
                           name="rs")
    full = np.arange(4 * size).reshape(2 * size, 2) * \
        sum(r + 1 for r in range(size))
    check("rs", rs, full[2 * rank:2 * rank + 2])
    hvd.barrier()
    for _ in range(5):
        check("steady", hvd.allreduce(torch.ones(4), op=hvd.Sum,
                                      name="steady"), np.full(4, size))
    if hvd.broadcast_object({"r": rank}, root_rank=0) != {"r": 0}:
        bad.append("broadcast_object")
    return bad


def _eager_timing(hvd, core, rank: int, size: int) -> dict:
    """bench.py's eager leg (``_eager_worker``, ``:884-940``): the steady
    cached cycle rate and the 16 MiB fp32 allreduce bandwidth on the plane
    this world formed, with the plane that served each op."""
    small = torch.ones(64)
    for _ in range(20):
        hvd.allreduce(small, op=hvd.Sum, name="cycle")
    t0 = time.perf_counter()
    for _ in range(200):
        hvd.allreduce(small, op=hvd.Sum, name="cycle")
    cycles_per_s = 200 / (time.perf_counter() - t0)
    st = core.global_state()
    shm = next((b for b in st.op_manager.backends if b.name == "shm"), None)
    big = torch.ones(EAGER_BIG_BYTES // 4)

    def bandwidth(name):
        for _ in range(2):
            hvd.allreduce(big, op=hvd.Sum, name=name)
        before = shm.ops_executed if shm is not None else 0
        t0 = time.perf_counter()
        for _ in range(5):
            out = hvd.allreduce(big, op=hvd.Sum, name=name)
        dt = time.perf_counter() - t0
        assert float(out[0]) == size and float(out[-1]) == size
        coll = st.tcp_collectives[0]
        plane = "shm" if shm is not None and shm.ops_executed > before \
            else f"tcp-{coll.last_algo}" + \
            ("-native" if coll.last_native else "-python")
        moved = 5 * EAGER_BIG_BYTES * 2 * (size - 1) / size
        return {"gbyte_per_s": moved / dt / 1e9, "ms": dt / 5 * 1e3,
                "plane": plane}

    out = {"cycles_per_s": cycles_per_s,
           "cycle_plane": "shm" if shm is not None else "tcp",
           "big": bandwidth("ring")}
    if shm is None:
        # The same op through the plain Python ring: every rank flips the
        # knob at the same point (the frames are the same either way).
        os.environ["HOROVOD_TPU_DISABLE_NATIVE"] = "1"
        try:
            out["big_python_ring"] = bandwidth("ring_py")
        finally:
            del os.environ["HOROVOD_TPU_DISABLE_NATIVE"]
    return out


def _eager_ladder(hvd, core) -> dict:
    """bench.py's ladder (``_ladder_worker``, ``:959-990``): ring against
    tree at each payload on the flat TCP plane, median of 5."""
    st = core.global_state()
    out = {}
    for algo in ("ring", "tree"):
        for c in st.tcp_collectives:      # a symmetric flip on every rank
            c.algo = algo
        for nb in LADDER_BYTES:
            x = torch.ones(max(nb // 4, 1))
            name = f"ladder_{algo}_{nb}"
            hvd.allreduce(x, op=hvd.Sum, name=name)
            samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                hvd.allreduce(x, op=hvd.Sum, name=name)
                samples.append(time.perf_counter() - t0)
            out[f"{algo}_{nb}"] = statistics.median(samples) * 1e3
            out[f"{algo}_{nb}_ran"] = st.tcp_collectives[0].last_algo
    return out


def eager_worker(job: str, rank: int, size: int, port: int,
                 outdir: str) -> int:
    """One rank of an eager world (``chip_smoke.py --eager-worker ...``):
    runs ``job`` and writes ``<job>_<rank>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core, native
    result: dict = {}
    base = dict(os.environ)

    def world(epoch: str, **env):
        os.environ.clear()
        os.environ.update(base, HOROVOD_RENDEZVOUS_EPOCH=epoch, **env)
        hvd.init()
        return [b.name for b in core.global_state().op_manager.backends]

    if job == "check":
        result["planes"] = world(
            "check", HOROVOD_TIMELINE=os.path.join(outdir, "timeline.json"))
        result["problems"] = _eager_check(hvd, rank, size)
        hvd.shutdown()
    elif job == "timing":
        result["tcp_planes"] = world("tcp", HOROVOD_SHM_OPERATIONS="0")
        result["tcp"] = _eager_timing(hvd, core, rank, size)
        hvd.shutdown()
        result["shm_planes"] = world(
            "shm", HOROVOD_SHM_OPERATIONS="1",
            HOROVOD_SHM_CAPACITY=str(EAGER_BIG_BYTES))
        result["shm"] = _eager_timing(hvd, core, rank, size)
        hvd.shutdown()
    elif job == "visible":
        # Every rank sees the one card: no device plane forms, CPU
        # tensors ride the host planes, and a CUDA tensor is refused.
        result["planes"] = world("visible")
        result["device_index"] = core.global_state().device_index
        result["cpu_sum"] = hvd.allreduce(
            torch.full((4,), float(rank + 1)), name="visible",
            op=hvd.Sum).tolist()
        try:
            hvd.allreduce(torch.ones(2, device="cuda"), name="visible.cuda")
            result["cuda_refusal"] = None
        except RuntimeError as exc:
            result["cuda_refusal"] = str(exc)
        hvd.shutdown()
        try:
            world("visible-required", HOROVOD_NCCL_OPERATIONS="1")
            result["required_refusal"] = None
        except RuntimeError as exc:
            result["required_refusal"] = str(exc)
        hvd.shutdown()
    elif job == "reduce":
        result = _reduce_world(hvd, core, world, rank, size)
    elif job == "reduce-hier":
        result = _reduce_hier_world(hvd, core, world, rank, size)
    elif job == "runtime":
        result = _runtime_world(hvd, core, world, rank, size, outdir)
    elif job.startswith("rserve-"):
        result = _resilience_serve_rank(hvd, world, rank, outdir, job[7:])
    else:
        result["planes"] = world("ladder", HOROVOD_SHM_OPERATIONS="0")
        result["ladder"] = _eager_ladder(hvd, core)
        hvd.shutdown()
    result["native_loaded"] = native.loaded()
    result["native_calls"] = dict(native.calls)
    with open(os.path.join(outdir, f"{job}_{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def _eager_world(job: str, size: int, outdir: str,
                 hide_cuda: bool = True,
                 expected_rcs: dict | None = None) -> list[dict | None]:
    """Spawn one world of ``size`` ranks against the port's own
    RendezvousServer; every rank within EAGER_WORLD_TIMEOUT, with exit
    code 0 unless ``expected_rcs`` names another (a rank expected to die
    reports nothing: its entry is None)."""
    expected_rcs = expected_rcs or {}
    from horovod_tpu_torch.runner.network import RendezvousServer
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    if hide_cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""      # the eager planes are host
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--eager-worker", job,
         str(r), str(size), str(port), outdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    failures = []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=EAGER_WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"rank {r} timed out")
            if p.returncode != expected_rcs.get(r, 0):
                failures.append(f"rank {r} rc={p.returncode}: "
                                + out.decode(errors="replace")[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    if failures:
        raise RuntimeError(f"eager {job} world: " + "; ".join(failures))
    results = []
    for r in range(size):
        if expected_rcs.get(r, 0) != 0:
            results.append(None)
            continue
        with open(os.path.join(outdir, f"{job}_{r}.json")) as f:
            results.append(json.load(f))
    return results


def _host() -> dict:
    """The host's CPU as lscpu and /proc/cpuinfo name it (a VM may say
    "unknown" in either), its core count and /dev/shm's size."""
    model = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        for line in out.splitlines():
            key, _, value = line.partition(":")
            if key.strip() in ("Model name", "Vendor ID", "Architecture",
                               "CPU family", "Model", "Flags"):
                model[key.strip()] = value.strip()[:80]
    except OSError:
        pass
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model["cpuinfo"] = line.split(":", 1)[1].strip()
                break
    shm = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
    return {"cpu": model, "nproc": os.cpu_count(),
            "dev_shm_bytes": shm.f_frsize * shm.f_blocks if shm else 0}


def _native_times() -> dict:
    """Each native entry point against its plain version at the eager
    phase's sizes (the ring's two versions are timed in the worlds): the
    two outputs, each from the same inputs, must be bitwise equal, and
    each version is timed after."""
    from horovod_tpu_torch import native
    n = EAGER_BIG_BYTES // 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, generator=g)
    parts = list(x.split(n // 64))
    out = torch.empty(n)
    outs = [torch.empty(p.numel()) for p in parts]
    wire = torch.empty(native.wire_nbytes(n, 256, False), dtype=torch.uint8)
    dec = torch.empty(n)
    a64_0 = torch.randn(1 << 16, generator=g, dtype=torch.float64)
    a64 = a64_0.clone()
    b64 = torch.randn(1 << 16, generator=g, dtype=torch.float64)

    def nothing():
        pass

    # name: (call, bytes moved, reset of what it writes, its output)
    calls = {
        "pack": (lambda: native.pack(parts, [p.numel() for p in parts],
                                     out), n * 8, nothing, lambda: [out]),
        "unpack": (lambda: native.unpack(out, outs), n * 8, nothing,
                   lambda: outs),
        "scale_f32": (lambda: native.scale_(out, 0.5), n * 8,
                      lambda: out.copy_(x), lambda: [out]),
        "qencode_int8": (lambda: native.qencode(x, 256, 256, False, wire),
                         n * 5, nothing, lambda: [wire]),
        "qdecode_int8": (lambda: native.qdecode(wire, n, 256, False, dec,
                                                True), n * 9,
                         lambda: dec.copy_(x), lambda: [dec]),
        "dot_norms_f64": (lambda: native.dot_norms(a64, b64),
                          a64.numel() * 16, nothing,
                          lambda: [torch.tensor(native.dot_norms(a64, b64),
                                                dtype=torch.float64)]),
        "scaled_add_f64": (lambda: native.scaled_add_(a64, b64, 0.5, 0.5),
                           a64.numel() * 24, lambda: a64.copy_(a64_0),
                           lambda: [a64]),
    }
    times, unequal = {}, []
    for name, (fn, nbytes, reset, result) in calls.items():
        row = {"bytes": nbytes}
        got = {}
        for mode in ("native", "plain"):
            if mode == "plain":
                os.environ["HOROVOD_TPU_DISABLE_NATIVE"] = "1"
            try:
                reset()
                fn()
                got[mode] = [t.clone() for t in result()]
                samples = []
                for _ in range(3 if mode == "plain" else 5):
                    t0 = time.perf_counter()
                    fn()
                    samples.append((time.perf_counter() - t0) * 1e3)
                row[f"{mode}_ms"] = statistics.median(samples)
            finally:
                os.environ.pop("HOROVOD_TPU_DISABLE_NATIVE", None)
        row["bitwise_equal"] = all(
            torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(got["native"], got["plain"]))
        if not row["bitwise_equal"]:
            unequal.append(name)
        times[name] = row
    if unequal:
        raise RuntimeError(f"native entry points differ from their plain "
                           f"versions: {unequal}")
    return times


def phase_eager() -> dict:
    """The eager Horovod core on this machine's host (see the module
    docstring)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import native
    t_phase = time.perf_counter()
    problems: list[str] = []
    t0 = time.perf_counter()
    native.load()
    host = _host()
    emit({"phase": "eager", "leg": "native",
          "build_s": native.build_seconds,
          "load_s": time.perf_counter() - t0, "cpu_tag": native.cpu_tag(),
          "loaded": native.loaded(), "library": native.library_path(),
          **host})
    if not native.loaded() or native.disabled():
        problems.append("the native library is not loaded")
    with tempfile.TemporaryDirectory(prefix="eager") as outdir:
        check = _eager_world("check", 2, outdir)
        timeline = {}
        for r in range(2):
            path = os.path.join(outdir, "timeline.json" if r == 0
                                else f"timeline.r{r}.json")
            with open(path) as f:
                events = json.load(f)
            names = {e.get("name") for e in events}
            timeline[r] = {
                "events": len(events),
                "negotiate": sorted(n for n in names
                                    if str(n).startswith("NEGOTIATE_")),
                "ops": sorted(n for n in names if n in (
                    "ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL",
                    "REDUCESCATTER", "SHM_ALLREDUCE", "TCP_RING_ALLREDUCE"))}
            if not timeline[r]["negotiate"] or not timeline[r]["ops"]:
                problems.append(f"rank {r}'s timeline lacks negotiation or "
                                f"op events")
        for r, res in enumerate(check):
            problems += [f"check rank {r}: {p}" for p in res["problems"]]
            if not res["native_loaded"] or not res["native_calls"].get(
                    "pack"):
                problems.append(f"check rank {r}: the native pack did not "
                                f"run")
        emit({"phase": "eager", "leg": "check", "ranks": 2,
              "planes": check[0]["planes"], "timeline": timeline,
              "native_calls": check[0]["native_calls"],
              "problems": sum((len(r["problems"]) for r in check), 0)})
        timing = _eager_world("timing", 2, outdir)[0]
        if timing["shm"]["big"]["plane"] != "shm" or \
                "shm" not in timing["shm_planes"]:
            problems.append("the shm leg did not run on the shm plane")
        if not timing["tcp"]["big"]["plane"].startswith("tcp-ring-native"):
            problems.append("the tcp leg did not run the native ring")
        emit({"phase": "eager", "leg": "timing", "ranks": 2,
              "native_calls": timing["native_calls"],
              "tcp_planes": timing["tcp_planes"],
              "shm_planes": timing["shm_planes"],
              "shm_capacity": EAGER_BIG_BYTES,
              "payload_bytes": EAGER_BIG_BYTES, **host,
              "tcp": timing["tcp"], "shm": timing["shm"]})
        lad = _eager_world("ladder", 4, outdir)[0]["ladder"]
        ladder = {str(nb): {"ring_ms": lad[f"ring_{nb}"],
                            "tree_ms": lad[f"tree_{nb}"],
                            "ran": [lad[f"ring_{nb}_ran"],
                                    lad[f"tree_{nb}_ran"]]}
                  for nb in LADDER_BYTES}
        crossover = max((nb for nb in LADDER_BYTES
                         if lad[f"tree_{nb}"] < lad[f"ring_{nb}"]),
                        default=0)
        emit({"phase": "eager", "leg": "ladder", "ranks": 4,
              "ladder": ladder, "tree_ring_crossover_bytes": crossover})
        visible = _eager_world("visible", 2, outdir, hide_cuda=False)
        for r, res in enumerate(visible):
            if "nccl" in res["planes"] or res["cpu_sum"] != [3.0] * 4:
                problems.append(f"cuda-visible rank {r}: planes "
                                f"{res['planes']}, sum {res['cpu_sum']}")
            if "device plane" not in (res["cuda_refusal"] or ""):
                problems.append(f"cuda-visible rank {r}: a CUDA tensor "
                                f"gave {res['cuda_refusal']}")
            if "share a card" not in (res["required_refusal"] or ""):
                problems.append(f"cuda-visible rank {r}: the knob at 1 "
                                f"gave {res['required_refusal']}")
        emit({"phase": "eager", "leg": "cuda-visible", "ranks": 2,
              "planes": visible[0]["planes"],
              "device_index": [res["device_index"] for res in visible],
              "cuda_refusal": visible[0]["cuda_refusal"],
              "required_refusal": visible[0]["required_refusal"]})
    natives = _native_times()
    emit({"phase": "eager", "leg": "native-times", "kernels": natives,
          "ring": {"native_ms": timing["tcp"]["big"]["ms"],
                   "plain_ms": timing["tcp"]["big_python_ring"]["ms"]}})
    # A CUDA tensor at one rank stays on its card (the binding phase
    # drives the device plane).
    os.environ.pop("HOROVOD_RANK", None)
    os.environ.pop("HOROVOD_SIZE", None)
    hvd.init()
    try:
        out = hvd.allreduce(torch.ones(4, device="cuda"), name="cuda")
        if out.device.type != "cuda" or out.tolist() != [1.0] * 4:
            problems.append(f"a CUDA tensor's allreduce gave {out}")
    finally:
        hvd.shutdown()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "eager", "leg": "summary", "seconds": seconds,
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds}


# ---------------------------------------------------------------------------
# The binding phase: the torch binding and the device plane on the card
# ---------------------------------------------------------------------------
BINDING_DTYPES = ("float16", "bfloat16", "float32", "float64", "int8",
                  "uint8", "int32", "int64", "int16", "uint16", "bool")
BINDING_FUSED_BYTES = 64 << 20          # the fused allreduce timed in (b)
BINDING_CYCLES = (20, 200)              # warm-up, timed cycles in (c)
BINDING_DTOH_MAX_MS = 0.02              # 1.3 MB at PCIe 5.0 x16's 64 GB/s


class _ResponseCount:
    """Counts the responses the core executes and their payload bytes, by
    wrapping the op manager's entry point (the background thread's only
    way to a plane)."""

    def __init__(self, core) -> None:
        from horovod_tpu_torch.common.dtypes import element_size
        self.responses = self.bytes = 0
        manager = core.global_state().op_manager
        inner = manager.execute_operation

        def counted(response, entries):
            self.responses += 1
            self.bytes += sum(response.tensor_sizes) * \
                element_size(response.tensor_type)
            return inner(response, entries)

        manager.execute_operation = counted

    def take(self) -> tuple[int, int]:
        out = (self.responses, self.bytes)
        self.responses = self.bytes = 0
        return out


def _binding_hook_path(opt, params) -> None:
    """What the optimizer's hooks and ``synchronize`` do in a world of
    more than one rank (``_allreduce_grad_async`` per gradient, then the
    install), driven by hand: in a world of one no hook registers."""
    pending = [(p, *opt._allreduce_grad_async(p)) for p in params]
    for _, handle, _ in pending:
        handle.wait().raise_if_error()
    for p, handle, (compressed, ctx) in pending:
        opt._install_grad(p, compressed, ctx, handle.outputs()[0])


def _binding_user_loop(problems: list[str]) -> dict:
    """Leg (a): gpt_small at full width trained as a Horovod user writes
    it, then ``Trainer.step`` on the same weights, batch and wire."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, core, gpt_small, native,
                                   synthetic_text_batch)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss

    cfg = gpt_small(attention="flash", max_seq_len=2048)
    batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
    steps = WARMUP_STEPS + TIMED_STEPS
    tokens = 8 * 2048
    calls = dict(native.calls)
    hvd.init()
    # Every Python thread alive in the loop takes the GIL from it.
    python_threads = sorted(t.name for t in threading.enumerate())
    try:
        count = _ResponseCount(core)
        model = TransformerLM(cfg, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.bf16)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        setup = count.take()

        def step():
            logits = model(batch["input"], train=True)
            loss = cross_entropy_loss(logits, batch["label"])
            loss.backward()
            opt.step()
            opt.zero_grad()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()                 # the main path starts
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        launches = fa.launch_counts()            # ... and ends
        responses, fused = count.take()
        peak = torch.cuda.max_memory_allocated()
        mean_ms = statistics.mean(step_ms[WARMUP_STEPS:])
        profile = _profile(step, mean_ms)
        # The hooks' path at one rank: every gradient through the core
        # and the basic plane on the card, as a world of more ranks
        # sends it to the device plane.
        params = [p for p in model.parameters() if p.requires_grad]
        cross_entropy_loss(model(batch["input"], train=True),
                           batch["label"]).backward()
        # Each installed gradient is its bf16 rounding, bit for bit: at
        # one rank the sum is the value itself and the average's scale 1.
        wire = [p.grad.detach().to(torch.bfloat16).to(p.grad.dtype)
                for p in params]
        _binding_hook_path(opt, params)
        count.take()
        hook_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _binding_hook_path(opt, params)
            torch.cuda.synchronize()
            hook_ms.append((time.perf_counter() - t0) * 1e3)
        hook_responses, hook_bytes = count.take()
        hook_profile = _profile(lambda: _binding_hook_path(opt, params),
                                statistics.median(hook_ms))
        # Idempotent: bf16 values come back as themselves every time.
        hook_unequal = sum(not torch.equal(p.grad, w)
                           for p, w in zip(params, wire))
        n_grads = len(params)
        del wire, params
        opt.zero_grad()
    finally:
        hvd.shutdown()
    native_moved = {k: v - calls.get(k, 0) for k, v in native.calls.items()
                    if v != calls.get(k, 0)}
    # The same loop once the core's background thread is gone: what its
    # 1 ms cycle, which takes the GIL, costs a host-bound step.
    bare_ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        cross_entropy_loss(model(batch["input"], train=True),
                           batch["label"]).backward()
        torch.optim.AdamW.step(opt)
        opt.zero_grad()
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt
    torch.cuda.empty_cache()

    # The Trainer on the bf16 wire (the gate), then on the plain wire:
    # at one rank no hook registers, so the loop's gradients never meet
    # the wire, and the plain Trainer tells whether the wire is all
    # that tells the two paths apart.
    trainers = {}
    for wire_kind in ("bf16", "none"):
        with _one_rank_nccl():
            model = TransformerLM(cfg, seed=0)
            trainer = Trainer(
                model, torch.optim.AdamW(model.parameters(), lr=3e-4,
                                         weight_decay=1e-4),
                build_mesh(dp=1), sync=GradSyncConfig(
                    op="average", compression=wire_kind))
            state = trainer.init(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_losses, t_ms = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, metrics = trainer.step(state, batch)
                torch.cuda.synchronize()
                t_ms.append((time.perf_counter() - t0) * 1e3)
                t_losses.append(metrics["loss"].item())
            trainers[wire_kind] = {
                "losses": t_losses, "step_ms": t_ms,
                "timed_step_ms_mean": statistics.mean(t_ms[WARMUP_STEPS:]),
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "loss_max_rel_diff": max(
                    abs(a - b) / abs(b) for a, b in zip(losses, t_losses))}
            del trainer, state, model
        torch.cuda.empty_cache()

    t_mean = trainers["bf16"]["timed_step_ms_mean"]
    rel = trainers["bf16"]["loss_max_rel_diff"]
    out = {"phase": "binding", "leg": "user-loop", "model": "gpt_small",
           "params": n_params, "batch": 8, "seq": 2048, "dtype": "bfloat16",
           "optimizer": "AdamW(3e-4, wd 1e-4)", "compression": "bf16",
           "losses": losses, "step_ms": step_ms,
           "timed_step_ms_mean": mean_ms,
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "without_core_thread": {
               "step_ms": bare_ms,
               "timed_step_ms_mean": statistics.mean(bare_ms)},
           "python_threads": python_threads,
           "peak_memory_bytes": peak, "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()},
           "setup_responses_bytes": list(setup),
           "core_responses_per_step": responses / steps,
           "core_fused_bytes_per_step": fused / steps,
           "hook_path": {"ms": hook_ms, "ms_median": statistics.median(
               hook_ms), "responses": hook_responses / 5,
               "bytes": hook_bytes / 5,
               "dtoh_max_ms": hook_profile["dtoh_max_ms"],
               "dtoh_copies": hook_profile["dtoh_copies"],
               "gradients": n_grads,
               "not_bf16_rounding": hook_unequal},
           "native_calls_during": native_moved,
           "trainer": {**trainers["bf16"],
                       "tokens_per_s": tokens / (t_mean / 1e3)},
           "trainer_plain_wire": trainers["none"],
           "step_ms_binding_vs_trainer": [mean_ms, t_mean],
           "loss_max_rel_diff": rel,
           "loss_max_rel_diff_plain_wire":
               trainers["none"]["loss_max_rel_diff"]}
    emit(out)
    emit({"phase": "profile", "leg": "binding-user-loop", **profile})
    emit({"phase": "profile", "leg": "binding-hook-path", **hook_profile})
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        problems.append(f"binding loop: losses {losses}")
    for name, c in launches.items():
        if c != cfg.num_layers * steps:
            problems.append(f"binding loop: {name} launched {c} times, not "
                            f"{cfg.num_layers} a step")
    if rel > 1e-3:
        problems.append(f"binding and Trainer losses differ by {rel:.3g}")
    if native_moved:
        problems.append(f"the native host kernels ran: {native_moved}")
    for name, prof in (("loop", profile), ("hook path", hook_profile)):
        if prof["dtoh_max_ms"] > BINDING_DTOH_MAX_MS:
            problems.append(f"binding {name}: a device-to-host copy of "
                            f"{prof['dtoh_max_ms']:.3f} ms")
    if hook_responses == 0:
        problems.append("the hook path ran no response on the card")
    if hook_unequal:
        problems.append(f"the hook path installed {hook_unequal} of "
                        f"{n_grads} gradients that are not their bf16 "
                        f"rounding")
    return out


def _torch_scale(x: torch.Tensor, f: float) -> torch.Tensor:
    """torch's own arithmetic for a scale factor: 16-bit floats in fp32,
    integers by the float64 factor truncated, bool and-ed."""
    if f == 1.0:
        return x
    if x.dtype in (torch.float16, torch.bfloat16):
        return (x.float() * f).to(x.dtype)
    if x.dtype == torch.bool:
        return x & bool(f)
    if not x.dtype.is_floating_point:
        return (x.double() * f).to(x.dtype)
    return x * f


def _binding_input(shape, dtype: str, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    if dtype == "bool":
        return torch.rand(shape, generator=g, device="cuda") < 0.3
    if dt.is_floating_point:
        return (torch.randn(shape, generator=g, device="cuda") * 8).to(dt)
    info = torch.iinfo(dt)
    return torch.randint(max(info.min // 4, -2 ** 40),
                         min(info.max // 4, 2 ** 40), shape, generator=g,
                         device="cuda", dtype=torch.int64).to(dt)


def _binding_plane(problems: list[str]) -> dict:
    """Leg (b): NcclBackend on a one-rank NCCL group, driven with
    responses built as the controller builds them."""
    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import from_any
    from horovod_tpu_torch.common.message import Response, ResponseType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch import native

    calls = dict(native.calls)
    plane = NcclBackend(NcclCommunicator(device=torch.device("cuda", 0)))
    results: dict[str, bool] = {}
    for i, dt in enumerate(BINDING_DTYPES):
        x = _binding_input((1000, 3), dt, seed=i)
        fused = [_binding_input(s, dt, seed=100 + i + j)
                 for j, s in enumerate(((7,), (), (64, 64), (33,)))]
        ttype = from_any(x.dtype)
        base = dict(devices=[0], tensor_type=ttype)

        def run(rtype, xs, splits=(), **kw):
            entries = [TensorTableEntry(tensor_name=f"t{j}", tensor=t)
                       for j, t in enumerate(xs)]
            entries[0].splits = list(splits)
            resp = Response(response_type=rtype,
                            tensor_names=[e.tensor_name
                                          for e in entries],
                            **base, **kw)
            assert plane.enabled(resp, entries)
            plane.execute(resp, entries).raise_if_error()
            return [e.output for e in entries]

        def same(tag, got, want):
            ok = got.dtype == want.dtype and got.shape == want.shape \
                and got.device == want.device and torch.equal(got, want)
            results[f"{tag}_{dt}"] = bool(ok)

        ar = ResponseType.ALLREDUCE
        for tag, pre, post in (("ar_sum", 1.0, 1.0),
                               ("ar_avg", 1.0, 1.0),
                               ("ar_scaled", 2.0, 0.25)):
            same(tag, run(ar, [x], tensor_sizes=[x.numel()],
                          prescale_factor=pre,
                          postscale_factor=post)[0],
                 _torch_scale(_torch_scale(x, pre), post))
        outs = run(ar, fused, tensor_sizes=[t.numel() for t in fused],
                   prescale_factor=2.0, postscale_factor=0.25)
        results[f"ar_fused_{dt}"] = all(
            torch.equal(o, _torch_scale(_torch_scale(t, 2.0), 0.25))
            and o.shape == t.shape for o, t in zip(outs, fused))
        same("ag", run(ResponseType.ALLGATHER, [x],
                       tensor_sizes=[x.shape[0]])[0], x)
        outs = run(ResponseType.ALLGATHER, [x, x[:0]],
                   tensor_sizes=[x.shape[0], 0])
        results[f"ag_fused_{dt}"] = torch.equal(outs[0], x) and \
            outs[1].shape == (0, 3)
        same("bc", run(ResponseType.BROADCAST, [x],
                       tensor_sizes=[x.numel()], root_rank=0)[0], x)
        same("a2a", run(ResponseType.ALLTOALL, [x],
                        splits=[x.shape[0]])[0], x)
        same("rs", run(ResponseType.REDUCESCATTER, [x],
                       tensor_sizes=[x.numel()], prescale_factor=2.0,
                       postscale_factor=0.25)[0],
             _torch_scale(_torch_scale(x, 2.0), 0.25))
    torch.cuda.synchronize()
    # A 64 MiB fused allreduce: 16 fp32 tensors of 4 MiB.
    parts = [torch.randn(BINDING_FUSED_BYTES // 64, device="cuda")
             for _ in range(16)]
    entries = [TensorTableEntry(tensor_name=f"f{j}", tensor=t)
               for j, t in enumerate(parts)]
    resp = Response(response_type=ResponseType.ALLREDUCE,
                    tensor_names=[e.tensor_name for e in entries],
                    devices=[0], tensor_type=from_any(torch.float32),
                    tensor_sizes=[t.numel() for t in parts])
    ms = time_ms(lambda: plane.allreduce(resp, entries), rounds=5,
                 warmup=2)
    bad = sorted(k for k, ok in results.items() if not ok)
    native_moved = {k: v - calls.get(k, 0) for k, v in native.calls.items()
                    if v != calls.get(k, 0)}
    # Pack into the fusion buffer and copy each result out: each byte
    # read and written twice.
    moved = 4 * BINDING_FUSED_BYTES
    out = {"phase": "binding", "leg": "device-plane", "ranks": 1,
           "backend": "nccl", "dtypes": list(BINDING_DTYPES),
           "checks": len(results), "mismatches": bad,
           "fused_allreduce": {
               "bytes": BINDING_FUSED_BYTES, "tensors": len(parts),
               "ms": ms, "gb_per_s": BINDING_FUSED_BYTES / ms / 1e6,
               "note": "one rank: no byte crosses a link, so this is "
                       "a copy: the pack into the fusion buffer, NCCL's "
                       "one-rank all-reduce and the copies out",
               "bytes_moved": moved,
               "bytes_bound_ms": moved / PEAK_BYTES_PER_S * 1e3},
           "native_calls_during": native_moved}
    emit(out)
    if bad:
        problems.append(f"device plane disagrees with torch: {bad}")
    if native_moved:
        problems.append(f"the plane ran native host kernels: {native_moved}")
    return out


def _binding_cycles(problems: list[str]) -> dict:
    """Leg (c): the eager API's cycle rate, a 64-float allreduce on a
    CUDA tensor and on a CPU tensor, at one rank."""
    import horovod_tpu_torch as hvd
    warmup, timed = BINDING_CYCLES
    rates = {}
    hvd.init()
    try:
        for where in ("cuda", "cpu"):
            x = torch.arange(64, dtype=torch.float32, device=where)
            for _ in range(warmup):
                out = hvd.allreduce(x, op=hvd.Sum, name=f"cycle.{where}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed):
                out = hvd.allreduce(x, op=hvd.Sum, name=f"cycle.{where}")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if out.device.type != where or not torch.equal(out, x):
                problems.append(f"allreduce of a {where} tensor gave "
                                f"{out.device} {out[:4].tolist()}")
            rates[where] = {"cycles_per_s": timed / seconds,
                            "us_per_cycle": seconds / timed * 1e6}
    finally:
        hvd.shutdown()
    out = {"phase": "binding", "leg": "eager-cycles", "ranks": 1,
           "elements": 64, "cycles": timed, **rates}
    emit(out)
    return out


def _binding_syncbn(problems: list[str]) -> dict:
    """Leg (d): ``_SyncBatchNormFn`` at one rank on the card against
    ``F.batch_norm`` in training mode, fp32."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(8, 64, 28, 28, device="cuda", generator=g) * 2 + 0.5
    w = torch.rand(64, device="cuda", generator=g) + 0.5
    b = torch.randn(64, device="cuda", generator=g)
    dy = torch.randn(x.shape, device="cuda", generator=g)
    got, ref = {}, {}
    hvd.init()
    try:
        for side, fn in (("sync", lambda *a: _SyncBatchNormFn.apply(*a)),
                         ("plain", lambda xi, wi, bi, rm, rv, eps, mom:
                          F.batch_norm(xi, rm, rv, wi, bi, True, mom,
                                       eps))):
            xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, w, b))
            rm, rv = torch.zeros(64, device="cuda"), \
                torch.ones(64, device="cuda")
            y = fn(xi, wi, bi, rm, rv, 1e-5, 0.1)
            y.backward(dy)
            (got if side == "sync" else ref).update(
                out=y.detach(), dx=xi.grad, dw=wi.grad, db=bi.grad,
                running_mean=rm, running_var=rv)
    finally:
        hvd.shutdown()
    err = {k: (got[k] - ref[k]).abs().max().item() for k in got}
    scale = {k: ref[k].abs().max().item() for k in got}
    out = {"phase": "binding", "leg": "syncbn", "shape": list(x.shape),
           "dtype": "float32", "max_abs_err": err, "max_abs_ref": scale,
           "tolerance": "1e-5 of max|ref|"}
    emit(out)
    bad = [k for k in got if err[k] > 1e-5 * max(scale[k], 1.0)]
    if bad:
        problems.append(f"SyncBatchNorm disagrees with F.batch_norm: {bad}")
    return out


def phase_binding() -> dict:
    """The torch binding and the device plane (see the module
    docstring)."""
    t_phase = time.perf_counter()
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    torch.cuda.empty_cache()
    problems: list[str] = []
    loop = _binding_user_loop(problems)
    with _one_rank_nccl():
        plane = _binding_plane(problems)
    cycles = _binding_cycles(problems)
    _binding_syncbn(problems)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "binding", "leg": "summary", "seconds": seconds,
          "step_ms": {"binding": loop["timed_step_ms_mean"],
                      "binding_without_core_thread":
                          loop["without_core_thread"]["timed_step_ms_mean"],
                      "trainer": loop["trainer"]["timed_step_ms_mean"]},
          "tokens_per_s": {"binding": loop["tokens_per_s"],
                           "trainer": loop["trainer"]["tokens_per_s"]},
          "loss_max_rel_diff": loop["loss_max_rel_diff"],
          "loss_max_rel_diff_plain_wire":
              loop["loss_max_rel_diff_plain_wire"],
          "plane_fused_gb_per_s": plane["fused_allreduce"]["gb_per_s"],
          "cycles_per_s": {k: cycles[k]["cycles_per_s"]
                           for k in ("cuda", "cpu")},
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": loop["launches"],
            "timed_step_ms_mean": loop["timed_step_ms_mean"]}


# ---------------------------------------------------------------------------
# The reduce phase: the eager reduction features (wire codecs, Adasum, the
# hierarchical plane) on the host planes and the device plane
# ---------------------------------------------------------------------------
REDUCE_BLOCK = 256
REDUCE_CODECS = ("none", "fp16", "bf16", "int8", "uint4")
REDUCE_TIMED = (2, 5)                   # warm-up, timed ops in (a)
REDUCE_DEVICE_N = (16 << 20, 1_000_003)  # 64 MiB of fp32, and ragged
ADASUM_N = 50304 * 768                  # gpt_small's token embedding
REDUCE_STEPS = (2, 3)                   # warm-up, timed steps in (d)


def _draw(key: str, rank: int, n: int):
    """Rank ``rank``'s input of one case, made with numpy from a seed."""
    import zlib

    import numpy as np
    rng = np.random.default_rng([zlib.crc32(key.encode()), rank])
    return (rng.standard_normal(n) * 2).astype(np.float32)


def _codec_oracle(xs: list, codec: str):
    """The reference's owner-reduce on every rank's input, in numpy:
    chunk j of each rank through the wire (a cast, or quantize and
    dequantize), summed in fp32 in rank order, rounded once (the cast
    codecs) or requantized once (int8/uint4)."""
    import numpy as np

    from horovod_tpu_torch.compress import (CompressionCodec, chunk_bounds,
                                            dequantize, quantize)

    def wire(x):
        if codec in ("fp16", "bf16"):
            dt = torch.float16 if codec == "fp16" else torch.bfloat16
            return torch.from_numpy(x).to(dt).float().numpy()
        c = CompressionCodec[codec.upper()]
        return dequantize(quantize(x, c, REDUCE_BLOCK))

    size, n = len(xs), xs[0].size
    bounds = chunk_bounds(n, size)
    out = np.empty(n, np.float32)
    for j in range(size):
        lo, hi = bounds[j], bounds[j + 1]
        acc = np.zeros(hi - lo, np.float32)
        for x in xs:
            acc += wire(x[lo:hi])
        out[lo:hi] = wire(acc)
    return out


def _reduce_check(hvd, rank: int, size: int) -> list[str]:
    """Each codec at a block-aligned length (the tree at 4 ranks) and a
    ring length, bitwise against ``_codec_oracle``; Adasum against
    ``adasum_reference`` within one fp32 ulp."""
    import numpy as np

    from horovod_tpu_torch.ops.adasum import adasum_reference
    bad = []
    for codec in REDUCE_CODECS[1:]:
        for n in (2 * REDUCE_BLOCK * size, 100003):
            key = f"{codec}{n}"
            xs = [_draw(key, r, n) for r in range(size)]
            got = hvd.allreduce(torch.from_numpy(xs[rank]), op=hvd.Sum,
                                name=key, compression=codec).numpy()
            if got.tobytes() != _codec_oracle(xs, codec).tobytes():
                bad.append(f"{codec} n={n}: not the oracle's bits")
    for n in (7, 4097, 100003):
        key = f"adasum{n}"
        xs = [_draw(key, r, n) for r in range(size)]
        got = hvd.allreduce(torch.from_numpy(xs[rank]), op=hvd.Adasum,
                            name=key).numpy()
        want = adasum_reference(xs).astype(np.float32)
        if not np.all(np.abs(got.astype(np.float64) - want)
                      <= np.spacing(np.abs(want))):
            bad.append(f"adasum n={n}: beyond one ulp of adasum_reference")
    return bad


def _reduce_timing(hvd, core, size: int) -> dict:
    """A 16 MiB fp32 allreduce on each codec: ms (mean of the timed ops),
    GB/s of fp32 payload at 2(n-1)/n bytes a rank, and the data mesh's
    bytes sent an op (the TCP plane; the shm plane moves no socket
    byte)."""
    st = core.global_state()
    mesh = st.tcp_collectives[0].mesh
    x = torch.from_numpy(_draw("timing", 0, EAGER_BIG_BYTES // 4))
    warmup, timed = REDUCE_TIMED
    out = {}
    for codec in REDUCE_CODECS:
        name = f"timing.{codec}"
        for _ in range(warmup):
            hvd.allreduce(x, op=hvd.Sum, name=name, compression=codec)
        sent = mesh.bytes_sent
        t0 = time.perf_counter()
        for _ in range(timed):
            hvd.allreduce(x, op=hvd.Sum, name=name, compression=codec)
        dt = (time.perf_counter() - t0) / timed
        out[codec] = {"ms": dt * 1e3,
                      "gbyte_per_s": EAGER_BIG_BYTES * 2 * (size - 1)
                      / size / dt / 1e9,
                      "wire_bytes_per_op": (mesh.bytes_sent - sent) / timed}
    plain = out["none"]["wire_bytes_per_op"]
    for codec in REDUCE_CODECS:
        out[codec]["wire_share"] = out[codec]["wire_bytes_per_op"] / plain \
            if plain else None
    return out


REDUCE_WORLD_PHASES = (
    ("tcp", dict(HOROVOD_SHM_OPERATIONS="0")),
    ("tcp-chain", dict(HOROVOD_SHM_OPERATIONS="0", HOROVOD_FUSED_KERNELS="0")),
    ("shm", dict(HOROVOD_SHM_OPERATIONS="1",
                 HOROVOD_SHM_CAPACITY=str(EAGER_BIG_BYTES))),
    ("shm-chain", dict(HOROVOD_SHM_OPERATIONS="1",
                       HOROVOD_SHM_CAPACITY=str(EAGER_BIG_BYTES),
                       HOROVOD_FUSED_KERNELS="0")),
)


def _reduce_world(hvd, core, world, rank: int, size: int) -> dict:
    """Job ``reduce`` of ``--eager-worker``: the codecs and Adasum on the
    TCP and shm planes, fused passes and per-chunk chain; the 16 MiB
    timings on the fused phases of the 2-rank world."""
    result: dict = {"problems": []}
    for phase, env in REDUCE_WORLD_PHASES:
        planes = world(f"reduce.{phase}", **env)
        shm = next((b for b in core.global_state().op_manager.backends
                    if b.name == "shm"), None)
        served = shm.ops_executed if shm is not None else 0
        result["problems"] += [f"{phase}: {p}" for p in
                               _reduce_check(hvd, rank, size)]
        if shm is not None and shm.ops_executed == served:
            result["problems"].append(f"{phase}: shm served nothing")
        if size == 2 and not phase.endswith("chain"):
            result[phase] = {"planes": planes,
                             **_reduce_timing(hvd, core, size)}
        hvd.shutdown()
    return result


def _reduce_hier_world(hvd, core, world, rank: int, size: int) -> dict:
    """Job ``reduce-hier``: two hosts of two ranks, host-major, both
    hierarchical knobs on; an allreduce bitwise against the two-level sum
    ((x0 + x1) + (x2 + x3) in fp32) and a ragged allgather, with the shm
    local legs and with the TCP ones."""
    import numpy as np
    result: dict = {"problems": []}
    layout = dict(HOROVOD_LOCAL_RANK=str(rank % 2), HOROVOD_LOCAL_SIZE="2",
                  HOROVOD_CROSS_RANK=str(rank // 2),
                  HOROVOD_CROSS_SIZE=str(size // 2),
                  HOROVOD_HIERARCHICAL_ALLREDUCE="1",
                  HOROVOD_HIERARCHICAL_ALLGATHER="1")
    for phase, env in (("shm-legs", {}),
                       ("tcp-legs", dict(HOROVOD_SHM_OPERATIONS="0"))):
        planes = world(f"hier.{phase}", **layout, **env)
        xs = [_draw("hier", r, 100003) for r in range(size)]
        got = hvd.allreduce(torch.from_numpy(xs[rank]), op=hvd.Sum,
                            name="hier").numpy()
        want = (xs[0] + xs[1]) + (xs[2] + xs[3])
        if got.tobytes() != want.tobytes():
            result["problems"].append(f"{phase}: allreduce is not the "
                                      f"two-level sum")
        got = hvd.allgather(torch.full((rank + 1, 3), float(rank)),
                            name="hier.ag").numpy()
        want = np.concatenate([np.full((r + 1, 3), float(r), np.float32)
                               for r in range(size)])
        if not np.array_equal(got, want):
            result["problems"].append(f"{phase}: ragged allgather")
        hier = next(b for b in core.global_state().op_manager.backends
                    if b.name == "tcp-hierarchical")
        result[phase] = {"planes": planes, "leg_ops": dict(hier.leg_ops),
                         "shm_local_legs": hier.shm_local is not None}
        hvd.shutdown()
    return result


def _reduce_plane(problems: list[str]) -> dict:
    """Leg (b): ``NcclBackend`` on a one-rank NCCL group: int8/uint4 at
    16 Mi and a ragged count of fp32 elements bitwise equal to the same
    code on the CPU tensor (the communicator over a one-rank gloo group)
    and within the reference's bound; fp16/bf16 equal ``x.to(dt).float()``;
    each timed beside the plain allreduce of the same 64 MiB buffer; a
    profiled int8 call's device-to-host copies."""
    import numpy as np

    import torch.distributed as dist

    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import from_any
    from horovod_tpu_torch.common.message import Response, ResponseType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch.compress import (CompressionCodec,
                                            roundtrip_error_bound)
    plane = NcclBackend(NcclCommunicator(device=torch.device("cuda", 0)))
    host = NcclCommunicator(group=dist.new_group(backend="gloo"),
                            device="cpu")
    out = {"phase": "reduce", "leg": "device-plane", "ranks": 1,
           "block": REDUCE_BLOCK, "cases": {}}
    for n in REDUCE_DEVICE_N:
        x_cpu = torch.from_numpy(_draw("plane", 0, n))
        x = x_cpu.cuda()
        entries = [TensorTableEntry(tensor_name="x", tensor=x)]

        def resp(codec):
            c = CompressionCodec[codec.upper()]
            return Response(response_type=ResponseType.ALLREDUCE,
                            tensor_names=["x"], devices=[0],
                            tensor_type=from_any(torch.float32),
                            tensor_sizes=[n], codec=int(c),
                            codec_block_size=REDUCE_BLOCK
                            if c in (CompressionCodec.INT8,
                                     CompressionCodec.UINT4) else 0)

        def run(r):
            plane.allreduce(r, entries)
            return entries[0].output

        for codec in REDUCE_CODECS:
            r = resp(codec)
            got = run(r)
            case = {"ms": time_ms(lambda: run(r), rounds=5, warmup=2)}
            if codec in ("int8", "uint4"):
                c = CompressionCodec[codec.upper()]
                want = host.quantized_allreduce(x_cpu, c, REDUCE_BLOCK)
                case["bitwise_equal_cpu"] = torch.equal(got.cpu(), want)
                err = np.abs(got.cpu().numpy().astype(np.float64)
                             - x_cpu.numpy())
                bound = 2 * roundtrip_error_bound(x_cpu.numpy(), c,
                                                  REDUCE_BLOCK) + 1e-5
                case["max_abs_err"] = float(err.max())
                case["within_bound"] = bool(np.all(err <= bound))
                if not (case["bitwise_equal_cpu"] and case["within_bound"]):
                    problems.append(f"device {codec} n={n}: {case}")
            elif codec != "none":
                dt = torch.float16 if codec == "fp16" else torch.bfloat16
                case["equal_cast"] = torch.equal(got, x.to(dt).float())
                if not case["equal_cast"]:
                    problems.append(f"device {codec} n={n}: not the cast")
            elif not torch.equal(got, x):
                problems.append(f"device plain allreduce n={n}")
            out["cases"][f"{codec}_{n}"] = case
        if n == REDUCE_DEVICE_N[0]:
            prof = _profile(lambda: run(resp("int8")),
                            out["cases"][f"int8_{n}"]["ms"])
            out["int8_profile"] = {k: prof[k] for k in (
                "kernel_ms", "kernel_launches", "device_idle_share",
                "dtoh_copies", "dtoh_max_ms", "empty_traces",
                "warmup_seen", "top")}
            out["int8_profile"]["top"] = prof["top"][:8]
            if prof["dtoh_max_ms"] > BINDING_DTOH_MAX_MS:
                problems.append(f"device int8: a device-to-host copy of "
                                f"{prof['dtoh_max_ms']:.3f} ms")
        del x, entries
    # The plain fused allreduce of the binding phase's leg (b): 64 MiB in 16
    # tensors, packed into the fusion buffer and copied out.
    parts = [torch.randn(BINDING_FUSED_BYTES // 64, device="cuda")
             for _ in range(16)]
    entries = [TensorTableEntry(tensor_name=f"f{j}", tensor=t)
               for j, t in enumerate(parts)]
    fused = Response(response_type=ResponseType.ALLREDUCE,
                     tensor_names=[e.tensor_name for e in entries],
                     devices=[0], tensor_type=from_any(torch.float32),
                     tensor_sizes=[t.numel() for t in parts])
    out["plain_fused_64mib_ms"] = time_ms(
        lambda: plane.allreduce(fused, entries), rounds=5, warmup=2)
    del parts, entries
    big = REDUCE_DEVICE_N[0]
    out["ms_vs_plain_64mib"] = {
        codec: out["cases"][f"{codec}_{big}"]["ms"]
        / out["cases"][f"none_{big}"]["ms"] for codec in REDUCE_CODECS}
    out["ms_vs_plain_fused_64mib"] = {
        codec: out["cases"][f"{codec}_{big}"]["ms"]
        / out["plain_fused_64mib_ms"] for codec in REDUCE_CODECS}
    emit(out)
    torch.cuda.empty_cache()
    return out


def _reduce_adasum_arith(problems: list[str]) -> dict:
    """Leg (c): the device plane's Adasum arithmetic (float64 dot
    products and ``adasum_combine``) at gpt_small's token embedding,
    against numpy's ``ops/adasum.py`` ``adasum_combine``, and timed."""
    import numpy as np

    from horovod_tpu_torch.backend.nccl import adasum_combine
    from horovod_tpu_torch.ops import adasum as host_adasum
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(ADASUM_N, generator=g, device="cuda",
                    dtype=torch.float64)
    b = torch.randn(ADASUM_N, generator=g, device="cuda",
                    dtype=torch.float64) * 0.5 + 0.25 * a

    def step():
        dots = torch.stack([a @ a, b @ b, a @ b])
        return adasum_combine(a, b, dots), dots

    got, dots = step()
    ms = time_ms(step, rounds=5, warmup=2)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    aa, bb, ab = float(a_np @ a_np), float(b_np @ b_np), float(a_np @ b_np)
    want = host_adasum.adasum_combine(a_np, b_np, aa, bb, ab)
    rel = float(np.max(np.abs(got.cpu().numpy() - want))
                / np.max(np.abs(want)))
    dots_rel = float(np.max(np.abs(dots.cpu().numpy() - [aa, bb, ab])
                            / np.abs([aa, bb, ab])))
    # Bound: a and b read once, the result written once, at 3.35 TB/s.
    bound_ms = 3 * 8 * ADASUM_N / PEAK_BYTES_PER_S * 1e3
    out = {"phase": "reduce", "leg": "adasum-arithmetic",
           "elements": ADASUM_N, "dtype": "float64", "ms": ms,
           "bytes_bound_ms": bound_ms, "max_rel_err": rel,
           "dots_max_rel_err": dots_rel, "tolerance": 1e-12}
    emit(out)
    if rel > 1e-12 or dots_rel > 1e-12:
        problems.append(f"device Adasum arithmetic off numpy's by {rel}")
    del a, b, got
    torch.cuda.empty_cache()
    return out


def _reduce_gpt(problems: list[str]) -> dict:
    """Leg (d): gpt_small at one rank through
    ``DistributedOptimizer(op=Adasum)`` and through
    ``compression=Compression.int8``, beside the plain AdamW loop on the
    same weights and batch: at one rank both are the wrapped step, so
    every loss must be the plain loop's, bit for bit."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import TransformerLM, gpt_small, \
        synthetic_text_batch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss
    cfg = gpt_small(attention="flash", max_seq_len=2048)
    batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
    steps = sum(REDUCE_STEPS)
    legs = {}
    hvd.init()
    try:
        for leg in ("plain", "adasum", "int8"):
            model = TransformerLM(cfg, seed=0)
            opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                    weight_decay=1e-4)
            if leg == "adasum":
                opt = hvd.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters(),
                    op=hvd.Adasum)
            elif leg == "int8":
                opt = hvd.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters(),
                    compression=hvd.Compression.int8)
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            losses, step_ms = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                loss = cross_entropy_loss(model(batch["input"], train=True),
                                          batch["label"])
                loss.backward()
                opt.step()
                opt.zero_grad()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())
            launches = fa.launch_counts()
            legs[leg] = {"losses": losses, "step_ms": step_ms,
                         "timed_step_ms_mean": statistics.mean(
                             step_ms[REDUCE_STEPS[0]:]),
                         "launches_per_step": {k: v / steps for k, v in
                                               launches.items()}}
            for name, c in launches.items():
                if c != cfg.num_layers * steps:
                    problems.append(f"reduce gpt {leg}: {name} launched "
                                    f"{c} times, not {cfg.num_layers} a "
                                    f"step")
            del model, opt
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    for leg in ("adasum", "int8"):
        legs[leg]["losses_bitwise_plain"] = \
            legs[leg]["losses"] == legs["plain"]["losses"]
        if not legs[leg]["losses_bitwise_plain"]:
            problems.append(f"reduce gpt {leg}: losses differ from the "
                            f"plain loop's")
    out = {"phase": "reduce", "leg": "gpt_small-one-rank", "ranks": 1,
           "batch": 8, "seq": 2048, "optimizer": "AdamW(3e-4, wd 1e-4)",
           **legs}
    emit(out)
    return out


def phase_reduce() -> dict:
    """The eager reduction features (see the module docstring)."""
    t_phase = time.perf_counter()
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    problems: list[str] = []
    host: dict = {}
    with tempfile.TemporaryDirectory(prefix="reduce") as outdir:
        for job, size in (("reduce", 2), ("reduce", 4),
                          ("reduce-hier", 4)):
            res = _eager_world(job, size, outdir)
            for r, rr in enumerate(res):
                problems += [f"{job} {size} rank {r}: {p}"
                             for p in rr["problems"]]
            host[f"{job}-{size}"] = {k: v for k, v in res[0].items()
                                     if k not in ("problems",
                                                  "native_loaded")}
    timing = host["reduce-2"]
    for plane in ("tcp", "shm"):
        emit({"phase": "reduce", "leg": f"host-{plane}", "ranks": 2,
              "payload_bytes": EAGER_BIG_BYTES, "block": REDUCE_BLOCK,
              **timing[plane]})
    tcp = timing["tcp"]
    for codec, want in (("int8", 0.258), ("uint4", 0.133)):
        share = tcp[codec]["wire_share"]
        if share is None or abs(share - want) > 0.01:
            problems.append(f"tcp {codec} wire share {share}, not {want}")
    emit({"phase": "reduce", "leg": "host-worlds",
          "worlds": {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("tcp", "shm")}
                     for k, v in host.items()}})
    with _one_rank_nccl():
        _reduce_plane(problems)
    _reduce_adasum_arith(problems)
    _reduce_gpt(problems)
    cards = torch.cuda.device_count()
    if cards < 2:
        across = f"not run: the machine shows {cards} card"
    else:
        across = _reduce_two_cards(problems)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "reduce", "leg": "summary", "seconds": seconds,
          "across_two_cards": across, "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds}


def reduce_card_worker(rank: int, port: int, outdir: str) -> int:
    """One rank of the 2-card check (``chip_smoke.py --reduce-card-worker
    <rank> <port> <outdir>``): legs (b) and (c) through ``NcclBackend``
    across two cards, against numpy."""
    import numpy as np

    import torch.distributed as dist

    from horovod_tpu_torch.backend.nccl import NcclCommunicator
    from horovod_tpu_torch.compress import (CompressionCodec, dequantize,
                                            quantize)
    from horovod_tpu_torch.ops.adasum import adasum_reference
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", port, 2, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                            device_id=torch.device("cuda", rank))
    try:
        comm = NcclCommunicator(device=torch.device("cuda", rank))
        xs = [_draw("two", r, REDUCE_DEVICE_N[1]) for r in range(2)]
        x = torch.from_numpy(xs[rank]).cuda(rank)
        res = {}
        for codec in ("int8", "uint4"):
            c = CompressionCodec[codec.upper()]
            got = comm.quantized_allreduce(x, c, REDUCE_BLOCK).cpu().numpy()
            # The device plane's wire: each rank quantized once, summed
            # in fp32, no requantization.
            want = dequantize(quantize(xs[0], c, REDUCE_BLOCK)) \
                + dequantize(quantize(xs[1], c, REDUCE_BLOCK))
            res[codec] = float(np.max(np.abs(got - want)))
            res[f"{codec}_ms"] = time_ms(
                lambda: comm.quantized_allreduce(x, c, REDUCE_BLOCK),
                rounds=5)
        got = comm.adasum(x).cpu().numpy()
        want = adasum_reference(xs).astype(np.float32)
        res["adasum_max_ulps"] = float(np.max(
            np.abs(got.astype(np.float64) - want)
            / np.spacing(np.abs(want))))
        res["adasum_ms"] = time_ms(lambda: comm.adasum(x), rounds=5)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"card_{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _reduce_two_cards(problems: list[str]) -> dict:
    """(b) and (c) across two ranks, one card each."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="cards") as outdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--reduce-card-worker", str(r), str(port), outdir])
            for r in range(2)]
        try:
            rcs = [p.wait(timeout=EAGER_WORLD_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            problems.append(f"two-card reduce workers exited {rcs}")
            return {"ran": False}
        with open(os.path.join(outdir, "card_0.json")) as f:
            res = json.load(f)
    if res["adasum_max_ulps"] > 1.0 or res["int8"] > 1e-4 or \
            res["uint4"] > 1e-4:
        problems.append(f"two-card reduce: {res}")
    return {"ran": True, "ranks": 2, **res}


# The runtime phase: the card leg's settings (name, environment over the
# process's, with {dir} for a scratch directory), the host worlds' stream
# counts and the autotuner's knobs, small enough to converge in a leg.
RUNTIME_SETTINGS = (
    ("off", {"HOROVOD_FLIGHT": "0"}),
    ("defaults", {}),
    ("observed", {"HOROVOD_METRICS": "1", "HOROVOD_METRICS_PORT": "{port}",
                  "HOROVOD_FINGERPRINT": "strict",
                  "HOROVOD_TIMELINE": "{dir}/timeline.json",
                  "HOROVOD_METRICS_FILE": "{dir}/metrics.json"}),
    # The observed setting's three instruments, each on alone.
    ("metrics", {"HOROVOD_METRICS": "1", "HOROVOD_METRICS_PORT": "{port}"}),
    ("strict", {"HOROVOD_FINGERPRINT": "strict"}),
    ("timeline", {"HOROVOD_TIMELINE": "{dir}/timeline.json"}),
    ("tuned", {"HOROVOD_AUTOTUNE": "1",
               "HOROVOD_AUTOTUNE_LOG": "{dir}/autotune.csv",
               "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
               "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
               "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3"}),
)
RUNTIME_KNOBS = ("HOROVOD_FLIGHT", "HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
                 "HOROVOD_FINGERPRINT", "HOROVOD_TIMELINE",
                 "HOROVOD_METRICS_FILE", "HOROVOD_AUTOTUNE",
                 "HOROVOD_AUTOTUNE_LOG", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES")
RUNTIME_PROFILED_STEPS = 3              # after the timed steps
# A full collection before each setting; CHIP_SMOKE_PRE_COLLECT=0 leaves
# the earlier phases' garbage in the heap, to see what it costs.
RUNTIME_PRE_COLLECT = os.environ.get("CHIP_SMOKE_PRE_COLLECT", "1") != "0"
RUNTIME_STREAMS = (1, 2, 4)
RUNTIME_TENSORS = 16                    # 16 MiB as 16 tensors of 1 MiB
RUNTIME_TUNE_BURSTS = 40
RUNTIME_FP_SECONDS = 10.0               # a divergence must not hang


def _scrape(port: int) -> dict:
    """One Prometheus scrape over loopback: every sample line must parse
    as ``name{labels} value``."""
    from urllib import request as urlrequest
    with urlrequest.urlopen(f"http://127.0.0.1:{port}/metrics",
                            timeout=30) as r:
        text = r.read().decode()
    samples = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")]
    bad = []
    for ln in samples:
        name, _, value = ln.rpartition(" ")
        try:
            float(value)
        except ValueError:
            bad.append(ln)
        if not name or not name.startswith("horovod_"):
            bad.append(ln)
    families = {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")}
    return {"parsed": not bad and bool(samples), "samples": len(samples),
            "metrics": len(families), "bad": bad[:3]}


def _core_pieces():
    """The eager core's functions the card leg times: (owner, attribute)
    pairs, an owner being a module or a class (patched for every
    instance)."""
    from horovod_tpu_torch import core
    from horovod_tpu_torch.analysis.fingerprint import FingerprintTracker
    from horovod_tpu_torch.backend.base import CollectiveBackend
    from horovod_tpu_torch.backend.basic import BasicBackend
    from horovod_tpu_torch.common.controller import Controller
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch.common.timeline import Timeline
    from horovod_tpu_torch.telemetry.flight import FlightRecorder
    from horovod_tpu_torch.telemetry.registry import MetricsRegistry
    return ((core, "enqueue_grouped_allreduce"),
            (Controller, "compute_response_list"),
            (core, "_pop_entries"), (core, "_execute_response"),
            (core, "_execute_on_card"),
            (CollectiveBackend, "pack_fusion_buffer"),
            (BasicBackend, "allreduce"),
            (CollectiveBackend, "unpack_fusion_buffer"),
            (TensorTableEntry, "finish"), (core, "_observe_collective"),
            (MetricsRegistry, "histogram"), (MetricsRegistry, "counter"),
            (FingerprintTracker, "fold"), (FingerprintTracker, "snapshot"),
            (Controller, "_check_fingerprints"), (Timeline, "_emit"),
            (FlightRecorder, "record"))


class _HostProfile:
    """Where the host's time goes in a setting's steps.  Over every step:
    the garbage collector's passes (``gc.callbacks``: ms by generation
    a step, and for each full pass its ms, objects collected and card
    bytes freed).  Inside ``timing()``: the inclusive host ms and calls
    a step of each of ``_core_pieces()``, by wrapping each (about a
    microsecond a call), on whichever thread calls it."""

    def __init__(self) -> None:
        self.gc_step_ms: list[list[float]] = []
        self.full_passes: list[dict] = []
        self.pieces: dict[str, list] = {}
        self._cur_gc = [0.0, 0.0, 0.0]
        self._cur = {}
        self._t_gc = 0.0
        self._mem_gc = 0

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t_gc = time.perf_counter()
            if info["generation"] == 2:
                self._mem_gc = torch.cuda.memory_allocated()
            return
        ms = (time.perf_counter() - self._t_gc) * 1e3
        self._cur_gc[info["generation"]] += ms
        if info["generation"] == 2:
            self.full_passes.append({
                "step": len(self.gc_step_ms), "ms": ms,
                "collected": info["collected"],
                "card_bytes_freed":
                    self._mem_gc - torch.cuda.memory_allocated()})

    def __enter__(self) -> "_HostProfile":
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._on_gc)

    def end_step(self) -> None:
        self.gc_step_ms.append(self._cur_gc)
        self._cur_gc = [0.0, 0.0, 0.0]
        for key, v in self._cur.items():
            self.pieces.setdefault(key, []).append(tuple(v))
            v[:] = [0.0, 0]

    @contextlib.contextmanager
    def timing(self):
        saved = []
        for owner, attr in _core_pieces():
            fn = getattr(owner, attr) if not isinstance(owner, type) \
                else owner.__dict__[attr]
            key = f"{getattr(owner, '__name__', owner)}.{attr}"
            cur = self._cur.setdefault(key, [0.0, 0])

            def timed(*args, _fn=fn, _cur=cur, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    _cur[0] += (time.perf_counter() - t0) * 1e3
                    _cur[1] += 1

            saved.append((owner, attr, fn))
            setattr(owner, attr, timed)
        try:
            yield
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

    def result(self) -> dict:
        pieces = {k.replace("horovod_tpu_torch.", ""): {
            "ms_a_step": statistics.mean(ms for ms, _ in v),
            "calls_a_step": statistics.mean(n for _, n in v)}
            for k, v in self.pieces.items()}
        return {"gc_ms_by_step": self.gc_step_ms,
                "gc_full_passes": self.full_passes, "pieces": pieces}


def _runtime_card_setting(name: str, env: dict, cfg, batch,
                          problems: list[str]) -> dict:
    """One setting of leg (a): a fresh model, optimizer and world of
    one; 2 + 5 + 3 steps with every gradient through the core, the last
    three with the core's pieces timed."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import TransformerLM, core, telemetry
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss
    timed = WARMUP_STEPS + TIMED_STEPS
    steps = timed + RUNTIME_PROFILED_STEPS
    saved = {k: os.environ.pop(k, None) for k in RUNTIME_KNOBS}
    out: dict = {"setting": name}
    with tempfile.TemporaryDirectory(prefix="rt") as tmp:
        port = _free_port()
        os.environ.update({k: v.format(dir=tmp, port=port)
                           for k, v in env.items()})
        # A full collection first, so that the garbage of earlier phases
        # and settings (models held in reference cycles) is not freed
        # inside this setting's steps.
        if RUNTIME_PRE_COLLECT:
            mem, t0 = torch.cuda.memory_allocated(), time.perf_counter()
            collected = gc.collect()
            out["pre_collect"] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "collected": collected,
                "card_bytes_freed": mem - torch.cuda.memory_allocated()}
        try:
            hvd.init()
            st = core.global_state()
            model = TransformerLM(cfg, seed=0)
            params = [p for p in model.parameters() if p.requires_grad]
            opt = torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

            allreduce_ms = []

            def step():
                loss = cross_entropy_loss(model(batch["input"], train=True),
                                          batch["label"])
                loss.backward()
                t_ar = time.perf_counter()
                grads = hvd.grouped_allreduce([p.grad for p in params],
                                              op=hvd.Average, name="grads")
                allreduce_ms.append((time.perf_counter() - t_ar) * 1e3)
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
                return loss

            out["threads"] = sorted(t.name for t in threading.enumerate())
            out["gc_objects"] = len(gc.get_objects())
            torch.cuda.synchronize()
            fa.reset_launch_counts()             # the path starts
            losses, step_ms = [], []

            def timed_step():
                t0 = time.perf_counter()
                loss = step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss.item())

            with _HostProfile() as profile:
                for _ in range(timed):
                    timed_step()
                    profile.end_step()
                with profile.timing():
                    for _ in range(RUNTIME_PROFILED_STEPS):
                        timed_step()
                        profile.end_step()
            launches = fa.launch_counts()        # ... and ends
            grad_bytes = sum(p.numel() * p.element_size() for p in params)
            out.update(
                losses=losses, step_ms=step_ms,
                timed_step_ms_mean=statistics.mean(
                    step_ms[WARMUP_STEPS:timed]),
                allreduce_host_ms=allreduce_ms,
                profiled_step_ms_mean=statistics.mean(step_ms[timed:]),
                host_profile=profile.result(),
                launches=launches,
                launches_per_step={k: v / steps
                                   for k, v in launches.items()},
                grad_bytes=grad_bytes, gradients=len(params),
                flight=st.flight.enabled,
                flight_events=len(st.flight.snapshot()))
            for kname, c in launches.items():
                if c != cfg.num_layers * steps:
                    problems.append(f"runtime {name}: {kname} launched {c} "
                                    f"times, not {cfg.num_layers} a step")
            if name == "observed":
                out.update(_runtime_observed(st, telemetry, steps,
                                             grad_bytes, len(params),
                                             problems))
            if name == "tuned":
                pm = st.parameter_manager
                out["tuner_done"] = pm is not None and pm._done
                out["applied"] = {
                    "fusion_threshold": st.controller.tensor_fusion_threshold,
                    "cycle_time_ms": st.cycle_time_ms}
                if not out["tuner_done"]:
                    problems.append("runtime tuned: the autotuner did not "
                                    "converge within the leg")
            del model, opt, params
        finally:
            hvd.shutdown()
            for k in RUNTIME_KNOBS:
                os.environ.pop(k, None)
            os.environ.update({k: v for k, v in saved.items()
                               if v is not None})
            torch.cuda.empty_cache()
        if name == "observed":
            with open(os.path.join(tmp, "metrics.r0.json")) as f:
                dump = json.load(f)
            with open(os.path.join(tmp, "timeline.json")) as f:
                text = f.read().strip()
            if not text.endswith("]"):
                text = text.rstrip(",\n") + "]"
            events = json.loads(text)
            out["metrics_dump_metrics"] = len(dump["metrics"])
            out["timeline_events"] = len(events)
            if not dump["metrics"] or not any(
                    str(e.get("name", "")).startswith("NEGOTIATE")
                    for e in events):
                problems.append("runtime observed: empty metrics dump or "
                                "timeline")
        if name == "tuned":
            with open(os.path.join(tmp, "autotune.csv")) as f:
                out["autotune_log"] = f.read().splitlines()
    return out


def _runtime_observed(st, telemetry, steps: int, grad_bytes: int,
                      n_grads: int, problems: list[str]) -> dict:
    """The observed setting's readings, taken before ``shutdown``."""
    from horovod_tpu_torch.telemetry import MetricsExporter
    snap = telemetry.metrics().snapshot()["metrics"]

    def hist(name):
        e = next(e for e in snap if e["name"] == name)
        return {"count": e["count"], "p50": e["p50"], "p99": e["p99"]}

    collective = sum(e["value"] for e in snap
                     if e["name"] == "horovod_collective_bytes_total")
    exporter = next(r for r in st.resources
                    if isinstance(r, MetricsExporter))
    scrape = _scrape(exporter.port)
    out = {"collective_bytes_per_step": collective / steps,
           "collective_latency_ms": hist("horovod_collective_latency_ms"),
           "cycle_ms": hist("horovod_controller_cycle_ms"),
           "cache_hit_rate": telemetry.summary()["cache_hit_rate"],
           "scrape": scrape, "exporter_port": exporter.port,
           "fingerprint_seq": st.controller.fingerprint.seq}
    if collective != grad_bytes * steps:
        problems.append(f"runtime observed: {collective} collective bytes "
                        f"over {steps} steps, not {grad_bytes} a step")
    if not scrape["parsed"]:
        problems.append(f"runtime observed: the scrape did not parse: "
                        f"{scrape['bad']}")
    if st.controller.fingerprint.seq != n_grads * steps:
        problems.append("runtime observed: the fingerprint folded "
                        f"{st.controller.fingerprint.seq} ops")
    return out


def _runtime_card(problems: list[str]) -> dict:
    """Leg (a): the four settings, then the losses held to each other."""
    from horovod_tpu_torch import gpt_small, synthetic_text_batch
    cfg = gpt_small(attention="flash", max_seq_len=2048)
    batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    legs = [_runtime_card_setting(name, env, cfg, batch, problems)
            for name, env in RUNTIME_SETTINGS]
    base = legs[0]["losses"]
    for leg in legs[1:]:
        leg["losses_bitwise_off"] = leg["losses"] == base
        if not leg["losses_bitwise_off"]:
            problems.append(f"runtime {leg['setting']}: losses differ from "
                            f"the all-off setting's")
    if not all(math.isfinite(x) for x in base) or base[-1] >= base[0]:
        problems.append(f"runtime: losses {base} not finite and falling")
    launches = {k: sum(leg["launches"][k] for leg in legs)
                for k in legs[0]["launches"]}
    out = {"phase": "runtime", "leg": "card", "ranks": 1, "batch": 8,
           "seq": 2048, "optimizer": "AdamW(3e-4, wd 1e-4)",
           "settings": legs, "launches": launches,
           "step_ms_vs_off": {leg["setting"]: leg["timed_step_ms_mean"]
                              / legs[0]["timed_step_ms_mean"]
                              for leg in legs}}
    emit(out)
    return out


def _runtime_world(hvd, core, world, rank: int, size: int,
                   outdir: str) -> dict:
    """One rank of leg (b): streams, the pipeline sweep and a fingerprint
    divergence."""
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.telemetry import flight
    out: dict = {"problems": []}
    problems = out["problems"]
    n = EAGER_BIG_BYTES // 4 // RUNTIME_TENSORS
    xs = [torch.full((n,), float(rank + 1 + i))
          for i in range(RUNTIME_TENSORS)]
    want = [float(sum(r + 1 + i for r in range(size)))
            for i in range(RUNTIME_TENSORS)]

    def burst(tag):
        hs = [hvd.allreduce_async(x, op=hvd.Sum, name=f"{tag}{i}")
              for i, x in enumerate(xs)]
        outs = [hvd.synchronize(h) for h in hs]
        for i, o in enumerate(outs):
            if not bool(o.eq(want[i]).all()):
                problems.append(f"{tag}{i}: {o[:2].tolist()} not {want[i]}")
        return outs

    for streams in RUNTIME_STREAMS:
        out[f"planes_s{streams}"] = world(
            f"rt-s{streams}", HOROVOD_SHM_OPERATIONS="0",
            HOROVOD_FUSION_THRESHOLD="0", HOROVOD_METRICS="1",
            HOROVOD_NUM_STREAMS=str(streams))
        st = core.global_state()
        for _ in range(2):
            burst("b")
        t0 = time.perf_counter()
        for _ in range(5):
            burst("b")
        dt = time.perf_counter() - t0
        native_ring = [c.last_native for c in st.tcp_collectives]
        if streams == max(RUNTIME_STREAMS):
            problems += _eager_check(hvd, rank, size)
        summ = telemetry.summary()
        moved = 5 * EAGER_BIG_BYTES * 2 * (size - 1) / size
        out[f"streams{streams}"] = {
            "ms": dt / 5 * 1e3, "gbyte_per_s": moved / dt / 1e9,
            "active_streams": st.active_streams,
            "dispatcher": st.stream_dispatcher is not None,
            "stream_busy_ms": summ.get("stream_busy_ms"),
            "stream_utilization": summ.get("stream_utilization"),
            "native_ring": native_ring}
        hvd.shutdown()

    world("rt-tune", HOROVOD_SHM_OPERATIONS="0",
          HOROVOD_NUM_STREAMS=str(max(RUNTIME_STREAMS)),
          HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_PIPELINE="1",
          HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
          HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1",
          HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="3",
          HOROVOD_AUTOTUNE_LOG=os.path.join(outdir, "autotune.csv"))
    st = core.global_state()
    t0 = time.perf_counter()
    for _ in range(RUNTIME_TUNE_BURSTS):
        burst("t")
    out["tune_seconds"] = time.perf_counter() - t0
    hvd.barrier()
    hvd.barrier()
    out["tuned"] = {
        "segment_bytes": [c.segment_bytes for c in st.tcp_collectives],
        "active_streams": st.active_streams,
        "algo": [c.algo for c in st.tcp_collectives],
        "tree_threshold": [c.tree_threshold for c in st.tcp_collectives],
        "fused": [bool(c.fused) for c in st.tcp_collectives],
        "fusion_threshold": st.controller.tensor_fusion_threshold,
        "cycle_time_ms": st.cycle_time_ms}
    if rank == 0:
        out["tuner_done"] = st.parameter_manager._done
        if not out["tuner_done"]:
            problems.append("the pipeline sweep did not converge")
    hvd.shutdown()
    if rank == 0:
        with open(os.path.join(outdir, "autotune.csv")) as f:
            out["autotune_log"] = f.read().splitlines()

    world("rt-fp", HOROVOD_SHM_OPERATIONS="0", HOROVOD_FINGERPRINT="strict",
          HOROVOD_FLIGHT_FILE=os.path.join(outdir, "flight.json"))
    hvd.allreduce(torch.ones(4), op=hvd.Sum, name="pre")
    t0 = time.perf_counter()
    try:
        hvd.allreduce(torch.ones(3 if rank == 1 else 4), op=hvd.Sum,
                      name="fp")
        err = None
        problems.append("the divergent allreduce returned")
    except Exception as exc:  # noqa: BLE001 - the error is the record
        err = f"{type(exc).__name__}: {exc}"
    out["fp_seconds"] = time.perf_counter() - t0
    out["fp_error"] = err
    rec = flight.recorder()
    out["fp_auto_dumps"] = rec.dumps
    if rec.dumps == 0:
        rec.dump(reason=err or "")
    with open(rec.last_dump_path) as f:
        dump = json.load(f)
    tail = dump["events"][-1]
    out["fp_dump"] = {"path": os.path.basename(rec.last_dump_path),
                      "events": len(dump["events"]), "tail": tail}
    names_op = tail["name"] == "fp" or "ALLREDUCE(fp," in tail["detail"]
    if not names_op:
        problems.append(f"flight dump tail does not name the op: {tail}")
    if err is None or "Collective fingerprint divergence" not in err:
        problems.append(f"divergence error: {err}")
    if out["fp_seconds"] > RUNTIME_FP_SECONDS:
        problems.append(f"the divergence took {out['fp_seconds']:.1f} s")
    out["fp_after"] = hvd.allreduce(torch.ones(2), op=hvd.Sum,
                                    name="after").tolist()
    hvd.shutdown()
    return out


def phase_runtime() -> dict:
    """The eager core's runtime half (see the module docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    card = _runtime_card(problems)
    host = {}
    with tempfile.TemporaryDirectory(prefix="runtime") as outdir:
        for size in (2, 4):
            sub = os.path.join(outdir, str(size))
            os.makedirs(sub)
            res = _eager_world("runtime", size, sub)
            for r, rr in enumerate(res):
                problems += [f"runtime {size} rank {r}: {p}"
                             for p in rr["problems"]]
            tuned = [rr["tuned"] for rr in res]
            if any(t != tuned[0] for t in tuned):
                problems.append(f"runtime {size}: ranks applied different "
                                f"tuned values: {tuned}")
            if any(rr["fp_auto_dumps"] != (1 if r == 0 else 0)
                   for r, rr in enumerate(res)):
                problems.append(f"runtime {size}: the coordinator did not "
                                f"dump its ring on the divergence")
            host[size] = res
            emit({"phase": "runtime", "leg": f"host-{size}", "ranks": size,
                  "payload_bytes": EAGER_BIG_BYTES,
                  "tensors": RUNTIME_TENSORS,
                  **{f"streams{s}": res[0][f"streams{s}"]
                     for s in RUNTIME_STREAMS},
                  "tuned": tuned[0], "tune_seconds": res[0]["tune_seconds"],
                  "autotune_log": res[0]["autotune_log"],
                  "fp_seconds": [rr["fp_seconds"] for rr in res],
                  "fp_error": res[0]["fp_error"],
                  "fp_dumps": [rr["fp_dump"] for rr in res],
                  "native_calls": res[0]["native_calls"]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "runtime", "leg": "summary", "seconds": seconds,
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": card["launches"]}


# ---------------------------------------------------------------------------
# resilience: the eager core's failure half
# ---------------------------------------------------------------------------
RES_FAULT_TIMEOUT = 5.0
# The serving world runs three quarters of the serve phase's timed
# workload (24 requests, 64-512 prompt tokens, 64 new, max_batch 8, dense)
# on gpt_small in fp32, so that the serve phase's near-argmax check holds
# every served token.  The two replicas' 16 slots take the first 16; the
# other 8 wait for a slot, so that the kill's survivor still has queued
# requests to admit in the shrunk world, and the unbroken legs reuse
# slots across the exchange.
# Collective 0 is the barrier before the requests; then a serve step
# makes four (the plan broadcast's size and data, the completions
# allgather's size and data): step s's allgather starts at collective
# 4s+3 and is named serve.done.g0.<s+1>.  Both faults land on one, which
# both ranks have negotiated, so rank 0 waits in the data plane on rank
# 1's bytes, under the op's deadline, with requests in flight.  (A fault
# on the plan broadcast would leave rank 0, its root, waiting in the next
# negotiation instead, which no request deadline bounds.)
RES_SERVE = dict(SERVE_TIMED, requests=24)
RES_KILL_OP = 1 + 4 * 20 + 2
RES_FREEZE_OP = 1 + 4 * 10 + 2
RES_FREEZE_MS = 30000
RES_FREEZE_SLO_MS = 2500.0
# (leg, environment, rank 1's exit code).
RES_SERVE_LEGS = (
    ("off", {}, 0),
    ("on", {"HOROVOD_FAULT_TOLERANCE": "1"}, 0),
    ("kill", {"HOROVOD_FAULT_TOLERANCE": "1",
              "HOROVOD_CHAOS": f"kill:rank=1,op={RES_KILL_OP},sig=9"}, -9),
    ("freeze", {"HOROVOD_FAULT_TOLERANCE": "1",
                "HOROVOD_CHAOS": f"freeze:rank=1,op={RES_FREEZE_OP},"
                                 f"ms={RES_FREEZE_MS}"}, 0),
)
# The host batteries of tests/torch_resilience_worker.py (CPU tensors,
# CUDA hidden; its FAULT_TIMEOUT): (battery, ranks, expected exit codes,
# the verdict every surviving rank prints; in the freeze only rank 0).
RES_HOST_FAULT_TIMEOUT = 3.0
RES_HOST_BATTERIES = (
    ("kill", 4, {2: -9}, "RanksFailedError("),
    ("retry", 4, {}, "retry converged after"),
    ("freeze", 2, {}, "wedged peer converted"),
    ("off", 2, {}, "off mode clean"),
)


def _resilience_serve_rank(hvd, world, rank: int, outdir: str,
                           leg: str) -> dict:
    """One rank of a serving world on the card (``--eager-worker
    rserve-<leg>``): gpt_small in fp32 through ``ReplicaExecutor``, the
    exchanges timed, the chaos fault's moment stamped by rank 1, and the
    error that ends rank 0's loop with the deadline it ran under."""
    from horovod_tpu_torch import TransformerLM, gpt_small, resilience
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    from horovod_tpu_torch.telemetry import flight
    torch.backends.cuda.matmul.allow_tf32 = False
    env = dict(next(e for name, e, _ in RES_SERVE_LEGS if name == leg),
               HOROVOD_SHM_OPERATIONS="0",
               HOROVOD_FAULT_TIMEOUT=str(RES_FAULT_TIMEOUT),
               HOROVOD_FLIGHT_FILE=os.path.join(outdir, f"flight-{leg}.json"))
    out: dict = {"planes": world(f"rserve-{leg}", **env)}
    chaos = resilience.chaos.active()
    if chaos is not None and rank == 1:
        # Stamp the moment the fault fires (wall clock, one host), just
        # before the engine kills or freezes this rank.
        fire_op = RES_KILL_OP if leg == "kill" else RES_FREEZE_OP
        on_response = chaos.on_response

        def stamped(names):
            if chaos._op_index == fire_op:
                with open(os.path.join(outdir, f"{leg}-fault-time"),
                          "w") as f:
                    f.write(repr(time.time()))
            return on_response(names)
        chaos.on_response = stamped
    cfg32 = gpt_small(dtype=torch.float32)
    ref = TransformerLM(cfg32, seed=0)
    cfg = dict(RES_SERVE["cfg"])
    if leg == "freeze":
        cfg["slo_ms"] = RES_FREEZE_SLO_MS
    ex = ReplicaExecutor(ServeConfig(model_cfg=cfg32, **cfg),
                         params=ref.state_dict(), device="cuda")
    fa.reset_launch_counts()
    streams, rid_prompt, exch_ms = {}, {}, []
    state = {"plan_ms": 0.0, "where": None, "call": None,
             "converted": None, "shrunk": None, "first_after": None,
             "gens": [], "assigned_gen": {}}
    plan_x, done_x = ex._exchange_plan, ex._exchange_completions
    collect = ex._collect_completions
    shrink = ex._shrink_and_resume

    def shrink_and_resume(exc):
        # Where the serve loop takes the error: the conversion's moment
        # (a confirmed death then shrinks, suspicion re-raises).
        state["converted"] = (time.time(), time.monotonic())
        shrink(exc)
        state["shrunk"] = time.time()

    def plan_exchange(plan):
        state["where"] = "plan"
        gen = ex._gen
        state["gens"].append(gen)
        t0 = time.perf_counter()
        plan = plan_x(plan)
        state["plan_ms"] = (time.perf_counter() - t0) * 1e3
        for a in plan.assign:
            if a.replica == ex.group:
                rid_prompt[a.rid] = list(a.tokens)
                state["assigned_gen"][a.rid] = gen
        return plan

    def done_exchange():
        state["where"] = "done"
        state["call"] = (time.monotonic(), ex._inflight_deadline())
        t0 = time.perf_counter()
        done = done_x()
        exch_ms.append(state["plan_ms"] + (time.perf_counter() - t0) * 1e3)
        if state["shrunk"] is not None and state["first_after"] is None:
            state["first_after"] = time.time()
        return done

    def record():
        for sl in ex.slots:
            if sl is not None and sl.remaining == 0:
                streams[sl.rid] = list(sl.generated)
        collect()
    ex._exchange_plan = plan_exchange
    ex._exchange_completions = done_exchange
    ex._collect_completions = record
    ex._shrink_and_resume = shrink_and_resume
    # Both ranks are built: the requests' deadlines start from here.
    hvd.barrier()
    if rank == 0:
        prompts = _prompt_pool(RES_SERVE, cfg32.vocab_size)
        for i in range(RES_SERVE["requests"]):
            ex.stats["offered"] += 1
            ex.queue.submit(prompts[i % len(prompts)], RES_SERVE["max_new"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err = None
    try:
        ex.serve_loop(stop_when=lambda: True)
    except hvd.HorovodInternalError as e:
        err = e
    t_err, t_err_mono = state["converted"] or (time.time(),
                                               time.monotonic())
    torch.cuda.synchronize()
    step = ex.admission._m_step
    out.update(
        leg=leg, wall_s=time.perf_counter() - t0, steps=ex._step,
        tokens=sum(len(g) for g in streams.values()),
        served=ex.stats["served"], offered=ex.stats["offered"],
        lost=ex.stats["lost"], expired=ex.stats["expired"],
        shrinks=ex.stats["shrinks"], gen=ex._gen,
        plan_gens=sorted(set(state["gens"])),
        served_by_gen={str(g): sum(
            1 for rid in streams if state["assigned_gen"].get(rid) == g)
            for g in sorted(set(state["gens"]))},
        shrunk_wall=state["shrunk"],
        first_step_after_wall=state["first_after"],
        step_ms={"p50": step.quantile(0.5), "p99": step.quantile(0.99),
                 "count": step.count},
        exchange_host_ms_per_step={
            "mean": statistics.fmean(exch_ms) if exch_ms else None,
            "p50": statistics.median(exch_ms) if exch_ms else None,
            "steps": len(exch_ms)},
        threads=sorted(t.name for t in threading.enumerate()),
        monitor=resilience.active_state() is not None,
        poll_s=getattr(resilience.active_state(), "poll_interval", None),
        chaos=chaos is not None,
        flash_launches=sum(fa.launch_counts().values()),
        error=None)
    if err is not None:
        t_call, deadline = state["call"] or (None, None)
        out["error"] = {
            "type": type(err).__name__, "text": str(err)[:300],
            "failed_ranks": sorted(getattr(err, "failed_ranks", ())),
            "op": getattr(err, "op", ""), "phase": getattr(err, "phase", ""),
            "wall_time": t_err, "in_exchange": state["where"],
            "waited_s": None if t_call is None else t_err_mono - t_call,
            "deadline_s": None if deadline is None else deadline - t_call,
            "inflight": len(ex.inflight_rids())}
    if err is None:
        out["check"] = _near_argmax(ref, streams, rid_prompt)
    elif rank == 0:
        rec = flight.recorder()
        events = []
        for _ in range(40):     # the other conversion may be rewriting it
            try:
                with open(rec.last_dump_path) as f:
                    events = json.load(f)["events"]
                break
            except (TypeError, OSError, ValueError):
                time.sleep(0.05)
        dispatched = [ev["name"] for ev in events
                      if ev["kind"] == "dispatch"]
        out["flight"] = {"dumps": rec.dumps, "path": rec.last_dump_path,
                         "last_dispatch": dispatched[-1] if dispatched
                         else None,
                         "tail": [[ev["kind"], ev["name"]]
                                  for ev in events[-6:]]}
        res = resilience.active_state()
        if leg == "freeze" and res is not None:
            # Past one more fault window the frozen rank's heartbeat
            # thread must still be beating: suspect, never confirmed.
            time.sleep(RES_FAULT_TIMEOUT + 1.0)
            out["after_window"] = {
                "failed": sorted(res.failed_ranks()),
                "confirmed_dead": sorted(
                    res.monitor.confirmed_failed_ranks())}
    ex.close()
    hvd.shutdown()
    return out


def _resilience_serve(problems: list[str]) -> dict:
    """Leg (a), (b) and (c): the 2-rank serving world on the one card,
    fault tolerance off and on, then a kill and a freeze."""
    legs = {}
    with tempfile.TemporaryDirectory(prefix="rserve") as outdir:
        for leg, _, rc1 in RES_SERVE_LEGS:
            r0, r1 = _eager_world(f"rserve-{leg}", 2, outdir,
                                  hide_cuda=False, expected_rcs={1: rc1})
            stamp = os.path.join(outdir, f"{leg}-fault-time")
            fault_at = None
            if os.path.exists(stamp):
                with open(stamp) as f:
                    fault_at = float(f.read())
            line = {"phase": "resilience", "leg": f"serve-{leg}",
                    "ranks": 2, "planes": r0["planes"],
                    "served": r0["served"], "offered": r0["offered"],
                    "steps": r0["steps"], "wall_s": r0["wall_s"],
                    "tokens": r0["tokens"] + (r1["tokens"] if r1 else 0),
                    "step_ms": r0["step_ms"],
                    "exchange_host_ms_per_step":
                        r0["exchange_host_ms_per_step"],
                    "threads": r0["threads"], "monitor": r0["monitor"],
                    "poll_s": r0["poll_s"], "chaos": r0["chaos"],
                    "flash_launches": r0["flash_launches"],
                    "lost": r0["lost"], "expired": r0["expired"],
                    "shrinks": r0["shrinks"], "gen": r0["gen"],
                    "plan_gens": r0["plan_gens"],
                    "served_by_gen": r0["served_by_gen"]}
            line["tokens_per_s"] = line["tokens"] / r0["wall_s"]
            if r0.get("check") is not None:
                line["check"] = {f"rank{r}": rr["check"] for r, rr
                                 in enumerate((r0, r1)) if rr}
            err = r0["error"]
            if err is not None:
                line["error"] = err
                line["fault_to_error_s"] = None if fault_at is None \
                    else err["wall_time"] - fault_at
                line["flight"] = r0.get("flight")
                line["after_window"] = r0.get("after_window")
                line["rank1_error"] = r1["error"] if r1 else None
                line["rank1_shrinks"] = r1["shrinks"] if r1 else None
            if leg == "kill":
                line["kill_to_first_step_after_shrink_s"] = None \
                    if fault_at is None or r0["first_step_after_wall"] \
                    is None else r0["first_step_after_wall"] - fault_at
                line["kill_to_shrunk_s"] = None if fault_at is None \
                    or r0["shrunk_wall"] is None \
                    else r0["shrunk_wall"] - fault_at
            emit(line)
            legs[leg] = line
            tag = f"resilience serve-{leg}"
            if "nccl" in line["planes"] or "shm" in line["planes"]:
                problems.append(f"{tag}: planes {line['planes']}")
            if line["flash_launches"]:
                problems.append(f"{tag}: flash launched while serving")
            if leg in ("off", "on"):
                if line["served"] != RES_SERVE["requests"] or err:
                    problems.append(f"{tag}: served {line['served']} of "
                                    f"{RES_SERVE['requests']}, error {err}")
                for rank, chk in line.get("check", {}).items():
                    if chk["beyond_tolerance"]:
                        problems.append(f"{tag} {rank}: tokens beyond "
                                        f"{NEAR_ARGMAX} of the full "
                                        f"forward's argmax: "
                                        f"{chk['beyond_tolerance']}")
                hb = any("heartbeat" in t for t in line["threads"])
                if hb != (leg == "on") or line["monitor"] != (leg == "on"):
                    problems.append(f"{tag}: monitor {line['monitor']}, "
                                    f"threads {line['threads']}")
                continue
            if leg == "kill":
                # The survivor shrinks past the dead rank and serves on.
                shrinks = [(x["dead"], x["from"], x["to"])
                           for x in line["shrinks"]]
                if err is not None or shrinks != [([1], 2, 1)]:
                    problems.append(f"{tag}: rank 0's error {err}, "
                                    f"shrinks {line['shrinks']}")
                if line["served"] + line["lost"] != line["offered"] \
                        or line["expired"] or not line["lost"]:
                    problems.append(
                        f"{tag}: served {line['served']} + lost "
                        f"{line['lost']} of {line['offered']}, expired "
                        f"{line['expired']}")
                if line["gen"] != 1 or line["plan_gens"] != [0, 1]:
                    problems.append(f"{tag}: generations "
                                    f"{line['plan_gens']}, last "
                                    f"{line['gen']}")
                # The requests queued at the kill: admitted by the
                # survivor in the shrunk world and served there.
                if not line["served_by_gen"].get("1"):
                    problems.append(f"{tag}: no request assigned under "
                                    f"generation 1 was served: "
                                    f"{line['served_by_gen']}")
                chk = line.get("check", {}).get("rank0")
                if chk is None or chk["beyond_tolerance"]:
                    problems.append(f"{tag}: the survivor's tokens: {chk}")
                took = line["kill_to_first_step_after_shrink_s"]
                if took is None or not took > 0:
                    problems.append(f"{tag}: kill to the first step after "
                                    f"the shrink {took} s")
                continue
            if err is None or err["type"] != "RanksFailedError" \
                    or err["failed_ranks"] != [1] or line["shrinks"]:
                problems.append(f"{tag}: rank 0's error {err}, shrinks "
                                f"{line['shrinks']}")
                continue
            last = (line["flight"] or {}).get("last_dispatch") or ""
            if not last.startswith(("serve.plan.g0.", "serve.done.g0.")):
                problems.append(f"{tag}: flight tail {line['flight']}")
            # A wait converts at its first poll past the op's budget,
            # floored at two polls (ResilienceState.op_timeout).
            poll = r0["poll_s"]
            bound = max(err["deadline_s"] or 0.0, 2 * poll) + poll
            if err["in_exchange"] != "done" \
                    or err["deadline_s"] is None \
                    or not err["waited_s"] < bound \
                    or not err["waited_s"] < RES_FAULT_TIMEOUT:
                problems.append(
                    f"{tag}: converted after {err['waited_s']} s in "
                    f"{err['in_exchange']} (deadline "
                    f"{err['deadline_s']} s, bound {bound} s)")
            after = line["after_window"] or {}
            if 1 in after.get("confirmed_dead", [1]):
                problems.append(f"{tag}: the frozen rank was "
                                f"declared dead: {after}")
            if line["rank1_error"] is None \
                    and not line["rank1_shrinks"]:
                problems.append(f"{tag}: the thawed rank saw no error "
                                f"and did not shrink")
    on, off = legs["on"]["step_ms"]["p50"], legs["off"]["step_ms"]["p50"]
    return {"on_over_off_step_p50": on / off if off else None,
            "tokens_per_s": {k: legs[k]["tokens_per_s"]
                             for k in ("off", "on")}}


def _resilience_host(problems: list[str]) -> dict:
    """Leg (d): the reference's four batteries on the port's host planes
    (tests/torch_resilience_worker.py; CPU tensors, CUDA hidden), the
    four worlds at once, each against its own RendezvousServer."""
    from horovod_tpu_torch.runner.network import RendezvousServer
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "torch_resilience_worker.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (here, env.get("PYTHONPATH")) if p))
    times = {}
    worlds = []
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        for battery, size, rcs, verdict in RES_HOST_BATTERIES:
            server = RendezvousServer()
            port = server.start()
            stack.callback(server.stop)
            outdir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="rhost"))
            procs = [subprocess.Popen(
                [sys.executable, worker, battery, str(r), str(size),
                 str(port), outdir], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(size)]
            stack.callback(lambda ps=procs: [p.kill() for p in ps
                                             if p.poll() is None])
            worlds.append((battery, size, rcs, verdict, procs))
        for battery, size, rcs, verdict, procs in worlds:
            outs = []
            for r, p in enumerate(procs):
                try:
                    o, _ = p.communicate(timeout=EAGER_WORLD_TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    o, _ = p.communicate()
                outs.append(o)
                if p.returncode != rcs.get(r, 0):
                    problems.append(f"resilience host-{battery} rank "
                                    f"{r} rc={p.returncode}: "
                                    f"{o[-1500:]}")
            judged = [0] if battery == "freeze" else \
                [r for r in range(len(outs)) if rcs.get(r, 0) == 0]
            lines = [next((ln for ln in outs[r].splitlines()
                           if verdict in ln), None) for r in judged]
            if None in lines:
                problems.append(f"resilience host-{battery}: no verdict "
                                f"{[o[-400:] for o in outs]}")
            took = [float(ln.split(" in ")[1].split("s")[0])
                    for ln in lines if ln and battery in ("kill", "freeze")]
            times[battery] = took
            emit({"phase": "resilience", "leg": f"host-{battery}",
                  "ranks": size, "fault_timeout_s": RES_HOST_FAULT_TIMEOUT,
                  "seconds_to_error": took, "verdicts": lines,
                  "wall_s": time.perf_counter() - t0})
    return times


def phase_resilience() -> dict:
    """The eager core's failure half (see the module docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    serve = _resilience_serve(problems)
    host = _resilience_host(problems)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "resilience", "leg": "summary", "seconds": seconds,
          **serve, "host_seconds_to_error": host, "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds}


# ---------------------------------------------------------------------------
# elastic: the launcher and elastic training on the card and on the host
# ---------------------------------------------------------------------------
ELASTIC_STEPS = 8
ELASTIC_FAIL_STEP = 4
ELASTIC_WORLD_TIMEOUT = 300.0
# A response index no run reaches: arms the chaos engine (whose count
# the unbroken run reads) without ever firing.
ELASTIC_NEVER = 10 ** 9


def _gpt_user_setup(hvd):
    """gpt_small at full width with the binding phase's optimizer:
    ``DistributedOptimizer(AdamW(3e-4, wd 1e-4))`` on the bf16 wire."""
    from horovod_tpu_torch import TransformerLM, gpt_small
    cfg = gpt_small(attention="flash", max_seq_len=2048)
    model = TransformerLM(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    return cfg, model, opt


def _exchange_grads(opt, params) -> None:
    """The gradients through the core as one grouped allreduce on the
    bf16 wire, installed as the optimizer's hooks install them in a world
    of more ranks (in a world of one no hook registers): at one rank the
    basic plane on the card, so every step has a gradient allreduce for
    the chaos engine to fail."""
    handle, ctxs = opt._grouped_allreduce_grad_async(params)
    handle.wait().raise_if_error()
    for p, (compressed, ctx), out in zip(params, ctxs, handle.outputs()):
        opt._install_grad(p, compressed, ctx, out)


def _params_digest(model) -> str:
    import hashlib
    digest = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        digest.update(name.encode())
        digest.update(t.detach().contiguous().view(torch.uint8).cpu()
                      .numpy().tobytes())
    return digest.hexdigest()


def _tensors(obj):
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _tensor_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _launch_static(outdir: str) -> dict:
    """Leg (a)'s worker: ``hvd.init()`` from the launcher's environment,
    then gpt_small through ``DistributedOptimizer`` as ``phase_binding``
    trains it (2 warm-up and 5 timed steps on one batch)."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import synthetic_text_batch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss

    rank_before_init = os.environ.get("HOROVOD_RANK")
    hvd.init()
    launcher_env = {k: os.environ.get(k) for k in (
        "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
        "HOROVOD_HOSTNAME", "HOROVOD_HOST_IDS",
        "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_JSRUN_HOSTS",
        "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")}
    try:
        cfg, model, opt = _gpt_user_setup(hvd)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
        steps = WARMUP_STEPS + TIMED_STEPS
        torch.cuda.synchronize()
        fa.reset_launch_counts()                 # the main path starts
        losses, step_ms, t_first = [], [], None
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = cross_entropy_loss(model(batch["input"], train=True),
                                      batch["label"])
            loss.backward()
            opt.step()
            opt.zero_grad()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            if t_first is None:
                t_first = time.time()
        launches = fa.launch_counts()            # ... and ends
        return {"rank": hvd.rank(), "size": hvd.size(),
                "launcher_env": launcher_env,
                "rank_env_before_init": rank_before_init,
                "t_first_step": t_first,
                "losses": losses, "step_ms": step_ms, "steps": steps,
                "launches": launches}
    finally:
        hvd.shutdown()


def _launch_elastic(outdir: str) -> dict:
    """Leg (b)'s worker: gpt_small under ``hvd.elastic.run`` over
    ``TorchState(model, optimizer, step=0)``, a commit after each of 8
    steps, every step's gradients through the core
    (``_exchange_grads``); then, in the unbroken run, the same 8 steps
    again without the elastic loop (the spread of two unbroken runs)."""
    import horovod_tpu_torch.torch as hvd
    import horovod_tpu_torch.torch.elastic  # noqa: F401 - hvd.elastic
    from horovod_tpu_torch import core, resilience, synthetic_text_batch
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.training import cross_entropy_loss
    run_module = sys.modules["horovod_tpu_torch.elastic.run"]
    manager = sys.modules["horovod_tpu_torch.elastic.worker"] \
        .notification_manager

    # The optimizer needs the world's size: take the first assignment
    # from the driver before hvd.init, as the programmatic bootstrap does.
    manager.init()
    assignment = manager.get_assignment(0)
    if assignment is None:
        raise RuntimeError("the driver left this slot out of the world")
    run_module._apply_assignment(assignment)
    hvd.init()
    cfg, model, opt = _gpt_user_setup(hvd)
    params = [p for p in model.parameters() if p.requires_grad]
    batches = [synthetic_text_batch(8, 2048, cfg.vocab_size, seed=s)
               for s in range(ELASTIC_STEPS + 1)]
    rec = {"losses": {}, "step_ms": {}, "op_at_step": {}, "commit_ms": [],
           "restore_ms": [], "faults": [], "resets": [], "resumed": [],
           "epochs": [os.environ["HOROVOD_RENDEZVOUS_EPOCH"]],
           "process_group": [multihost.is_initialized()],
           "forward_backward": 0}

    def one_step(s: int) -> float:
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(
            model(batches[s]["input"], train=True), batches[s]["label"])
        loss.backward()
        rec["forward_backward"] += 1
        try:
            _exchange_grads(opt, params)
        except HorovodInternalError:
            rec["faults"].append((s, time.time()))
            raise
        opt.step()
        value = loss.item()
        rec["step_ms"][s] = (time.perf_counter() - t0) * 1e3
        return value

    class State(hvd.elastic.TorchState):
        def restore(self):
            t0 = time.perf_counter()
            super().restore()
            torch.cuda.synchronize()
            rec["restore_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["restored_at"] = time.time()

    @hvd.elastic.run
    def train(state):
        while state.step < ELASTIC_STEPS:
            s = state.step + 1
            engine = resilience.chaos.active()
            rec["op_at_step"][s] = None if engine is None \
                else engine._op_index
            rec["losses"][s] = one_step(s)
            if len(rec["resumed"]) < len(rec["resets"]):
                rec["resumed"].append(time.time())
            state.step = s
            t0 = time.perf_counter()
            state.commit()
            torch.cuda.synchronize()
            rec["commit_ms"].append((time.perf_counter() - t0) * 1e3)
        return state.step

    def on_reset():
        rec["resets"].append(time.time())
        rec["epochs"].append(os.environ["HOROVOD_RENDEZVOUS_EPOCH"])
        rec["process_group"].append(multihost.is_initialized())

    state = State(model, opt, step=0)
    state.register_reset_callbacks([on_reset])
    torch.cuda.synchronize()
    fa.reset_launch_counts()                     # the main path starts
    rec["final_step"] = train(state)
    rec["launches"] = fa.launch_counts()         # ... and ends
    # What the last commit holds: the model's and AdamW's state, deep
    # copies on the card (the `step` scalars on the host).
    saved = [h._saved_state for h in state._handlers.values()]
    rec["commit_bytes"] = _tensor_bytes(saved)
    rec["commit_bytes_on_card"] = sum(
        _tensor_bytes(t) for t in _tensors(saved) if t.is_cuda)
    rec["digest"] = _params_digest(model)
    rec["rank"], rec["size"] = hvd.rank(), hvd.size()
    # The re-initialised core runs the card's work on a stream of its
    # own again (made at init in a world of one on the card).
    rec["device_stream"] = core.global_state().device_stream is not None
    if os.environ.get("CHIP_SMOKE_ELASTIC_SPREAD") == "1":
        # The same 8 steps again, from the same seed, without the
        # elastic loop: the spread of two unbroken runs.
        del state, opt, model, params
        torch.cuda.empty_cache()
        cfg, model, opt = _gpt_user_setup(hvd)
        params = [p for p in model.parameters() if p.requires_grad]
        rec["again"] = {s: one_step(s)
                        for s in range(1, ELASTIC_STEPS + 1)}
        rec["again_digest"] = _params_digest(model)
    hvd.shutdown()
    return rec


def launch_worker(mode: str, outdir: str) -> int:
    """``chip_smoke.py --launch-worker static|elastic OUTDIR``: the
    process the launcher starts on the card; its record goes to
    ``OUTDIR/<mode>.json``.  No card: exit 3."""
    if not torch.cuda.is_available():
        print("launch worker: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    rec = (_launch_static if mode == "static" else _launch_elastic)(outdir)
    rec["device"] = torch.cuda.get_device_name(0)
    with open(os.path.join(outdir, f"{mode}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _launcher_run(argv: list[str], env_extra: dict,
                  timeout: float = ELASTIC_WORLD_TIMEOUT) -> tuple[int, str]:
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p), **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        return -9, out
    return proc.returncode, out


def _elastic_card_leg(outdir: str, chaos: str, spread: bool
                      ) -> tuple[int, str, dict]:
    argv = ["--min-np", "1", "--max-np", "1", "-H", "localhost:1",
            "--elastic-timeout", "120", sys.executable,
            os.path.abspath(__file__), "--launch-worker", "elastic", outdir]
    rc, out = _launcher_run(argv, {
        "HOROVOD_CHAOS": chaos,
        "CHIP_SMOKE_ELASTIC_SPREAD": "1" if spread else "0"})
    path = os.path.join(outdir, "elastic.json")
    rec = {}
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        rec["losses"] = {int(k): v for k, v in rec["losses"].items()}
        rec["op_at_step"] = {int(k): v for k, v in
                             rec["op_at_step"].items()}
    return rc, out, rec


def phase_elastic(binding: dict | None = None) -> dict:
    """The launcher and elastic training (see the module docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    steps = WARMUP_STEPS + TIMED_STEPS
    per_step = 12                                # gpt_small's layers
    root = tempfile.mkdtemp(prefix="elastic")
    launches: dict[str, dict] = {}

    # (a) the static launcher, a world of one on the card.
    out_a = os.path.join(root, "static")
    os.makedirs(out_a)
    t_launch = time.time()
    rc, text = _launcher_run(
        ["-np", "1", "-H", "localhost:1", sys.executable,
         os.path.abspath(__file__), "--launch-worker", "static", out_a], {})
    wall_a = time.time() - t_launch
    static = {}
    if rc != 0 or not os.path.exists(os.path.join(out_a, "static.json")):
        problems.append(f"elastic (a): launcher rc {rc}: {text[-3000:]}")
    else:
        with open(os.path.join(out_a, "static.json")) as f:
            static = json.load(f)
        launches["static"] = static["launches"]
        mean_ms = statistics.mean(static["step_ms"][WARMUP_STEPS:])
        emit({"phase": "elastic", "leg": "static-launch",
              "command": "horovodrun-tpu-torch -np 1 -H localhost:1",
              "worker_rc": rc, "wall_s": wall_a,
              "launch_to_first_step_s": static["t_first_step"] - t_launch,
              "timed_step_ms_mean": mean_ms,
              "binding_timed_step_ms_mean":
                  None if binding is None else
                  binding.get("timed_step_ms_mean"),
              "losses": static["losses"],
              "launches_per_step": {n: c / steps for n, c in
                                    static["launches"].items()},
              "launcher_env": static["launcher_env"],
              "device": static["device"]})
        if (static["rank"], static["size"]) != (0, 1):
            problems.append(f"elastic (a): rank/size "
                            f"{static['rank']}/{static['size']}")
        if not all(math.isfinite(x) for x in static["losses"]) or \
                not static["losses"][-1] < static["losses"][0]:
            problems.append(f"elastic (a): losses {static['losses']}")
        for name, c in static["launches"].items():
            if c != per_step * steps:
                problems.append(f"elastic (a): {name} launched {c} times, "
                                f"not {per_step} a step")

    # (c) the host worlds start here and run beside (b)'s unbroken run:
    # the five scenarios of the integration tests through the launcher,
    # CPU tensors, CUDA hidden, all at once (their start-up, imports
    # mostly, sets their time), so each wall time is under the others'
    # load and the card worker's.  The chaos run waits for them to end.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_elastic_worker as worlds
    from concurrent.futures import ThreadPoolExecutor

    def scenario(name):
        out = os.path.join(root, f"host-{name}")
        os.makedirs(out)
        return worlds.run_scenario(name, out)

    t_host = time.perf_counter()
    pool = ThreadPoolExecutor(len(worlds.SCENARIOS))
    futures = [pool.submit(scenario, name) for name in worlds.SCENARIOS]

    # (b) the elastic launcher, a world of one on the card: an unbroken
    # run (the chaos engine armed, never firing, to read the response
    # index of step 4's exchange), then the same run with that response
    # failed once.
    out_u = os.path.join(root, "unbroken")
    out_c = os.path.join(root, "chaos")
    os.makedirs(out_u)
    os.makedirs(out_c)
    t0 = time.time()
    rc_u, text_u, unbroken = _elastic_card_leg(
        out_u, f"fail:op={ELASTIC_NEVER},rank=*", spread=True)
    wall_u = time.time() - t0
    results = [f.result() for f in futures]
    pool.shutdown()
    host = {"wall_s": time.perf_counter() - t_host}
    for name, res in zip(worlds.SCENARIOS, results):
        host[name] = {"seconds": res["seconds"],
                      "fault_to_recovery_s": res["fault_to_recovery_s"]}
        emit({"phase": "elastic", "leg": f"host-{name}",
              "wall_s": res["seconds"], "concurrent_worlds":
                  len(worlds.SCENARIOS),
              "fault_to_recovery_s": res["fault_to_recovery_s"],
              "markers": res.get("markers"), "problems": res["problems"]})
        problems += res["problems"]

    if rc_u != 0 or not unbroken:
        problems.append(f"elastic (b) unbroken: rc {rc_u}: {text_u[-3000:]}")
    else:
        k = unbroken["op_at_step"][ELASTIC_FAIL_STEP]
        t0 = time.time()
        rc_c, text_c, broken = _elastic_card_leg(
            out_c, f"fail:op={k},rank=*", spread=False)
        wall_c = time.time() - t0
        if rc_c != 0 or not broken:
            problems.append(f"elastic (b) chaos: rc {rc_c}: "
                            f"{text_c[-3000:]}")
        else:
            launches["elastic"] = broken["launches"]
            launches["elastic_unbroken"] = unbroken["launches"]
            ref_losses = [unbroken["losses"][s]
                          for s in range(1, ELASTIC_STEPS + 1)]
            got_losses = [broken["losses"][s]
                          for s in range(1, ELASTIC_STEPS + 1)]
            again = [unbroken["again"][str(s)]
                     for s in range(1, ELASTIC_STEPS + 1)]
            spread = max(abs(a - b) for a, b in zip(ref_losses, again))
            diff = max(abs(a - b) for a, b in zip(ref_losses, got_losses))
            fault = broken["faults"][0] if broken["faults"] else None
            restored_at = broken.get("restored_at")
            emit({"phase": "elastic", "leg": "elastic-card",
                  "command": "horovodrun-tpu-torch --min-np 1 --max-np 1 "
                             "-H localhost:1",
                  "chaos": f"fail:op={k},rank=*", "fail_step": fault and
                  fault[0], "wall_s": [wall_u, wall_c],
                  "losses_unbroken": ref_losses, "losses": got_losses,
                  "losses_again_unbroken": again,
                  "losses_bitwise_equal": got_losses == ref_losses,
                  "loss_max_abs_diff": diff,
                  "unbroken_spread": spread,
                  "params_bitwise_equal":
                      broken["digest"] == unbroken["digest"],
                  "params_unbroken_runs_equal":
                      unbroken["digest"] == unbroken["again_digest"],
                  "commit_ms": broken["commit_ms"],
                  "commit_ms_median": statistics.median(
                      broken["commit_ms"]),
                  "commit_bytes": broken["commit_bytes"],
                  "commit_bytes_on_card": broken["commit_bytes_on_card"],
                  "restore_ms": broken["restore_ms"],
                  "fault_to_first_resumed_step_s":
                      broken["resumed"][0] - fault[1]
                      if fault and broken["resumed"] else None,
                  "re_rendezvous_s":
                      broken["resets"][0] - restored_at
                      if broken["resets"] and restored_at else None,
                  "epochs": broken["epochs"],
                  "process_group_formed": broken["process_group"],
                  "device_stream_after_reinit": broken["device_stream"],
                  "step_ms": broken["step_ms"],
                  "step_ms_unbroken": unbroken["step_ms"],
                  "forward_backward_passes": broken["forward_backward"],
                  "launches_per_pass": {
                      n: c / broken["forward_backward"]
                      for n, c in broken["launches"].items()},
                  "device": broken["device"]})
            if not all(math.isfinite(x) for x in got_losses):
                problems.append(f"elastic (b): losses {got_losses}")
            if fault is None or fault[0] != ELASTIC_FAIL_STEP:
                problems.append(f"elastic (b): the fault hit "
                                f"{broken['faults']}, not step "
                                f"{ELASTIC_FAIL_STEP}")
            if len(broken["resets"]) != 1 or \
                    len(broken["restore_ms"]) != 1:
                problems.append(f"elastic (b): {len(broken['resets'])} "
                                f"re-rendezvous, {len(broken['restore_ms'])}"
                                f" restores")
            if broken["final_step"] != ELASTIC_STEPS:
                problems.append(f"elastic (b): ended at step "
                                f"{broken['final_step']}")
            # Bitwise, unless two unbroken runs differ (then within their
            # spread, and PERF.md names the op).
            exact = unbroken["digest"] == unbroken["again_digest"] and \
                ref_losses == again
            if exact and (got_losses != ref_losses or
                          broken["digest"] != unbroken["digest"]):
                problems.append("elastic (b): the restored run's losses or "
                                "parameters differ from the unbroken run's")
            if not exact and diff > spread:
                problems.append(f"elastic (b): loss difference {diff} over "
                                f"the unbroken spread {spread}")
            passes = broken["forward_backward"]
            if passes != ELASTIC_STEPS + 1:
                problems.append(f"elastic (b): {passes} forward/backward "
                                f"passes, not {ELASTIC_STEPS + 1}")
            for leg, rec, n in (("chaos", broken, passes),
                                ("unbroken", unbroken, ELASTIC_STEPS)):
                for name, c in rec["launches"].items():
                    if c != per_step * n:
                        problems.append(f"elastic (b) {leg}: {name} "
                                        f"launched {c} times in {n} "
                                        f"passes")

    seconds = time.perf_counter() - t_phase
    emit({"phase": "elastic", "leg": "summary", "seconds": seconds,
          "host": host, "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": {
        name: {leg: counts[name] for leg, counts in launches.items()}
        for name in REPLACES}}


# The parallel phase: gpt_small's legs (warm-up, timed steps), the ring
# leg's batch (fp32 scores at B=8 would need about 60 GB), the MoE legs'
# batch and experts, and the loss tolerance of legs against their
# references in bf16.
PARALLEL_STEPS = (2, 3)
PARALLEL_RING_BATCH = 2
PARALLEL_MOE = dict(batch=4, seq=1024, experts=8)
PARALLEL_LOSS_TOL = 5e-2
PARALLEL_MOE_CHECK_REL = 1e-4
PARALLEL_WORLD_TIMEOUT = 600.0


def _parallel_train(cfg, batch: dict, mesh, sync_kw: dict | None = None,
                    batch_spec=None, on_model=None) -> dict:
    """``Trainer.step`` on a model of ``cfg`` (seed 0) with AdamW(3e-4,
    wd 1e-4) and the bf16 wire: losses, step ms, peak memory and the
    flash launches of the warm-up and timed steps.  ``on_model(model)``
    runs once the model is built."""
    from horovod_tpu_torch import GradSyncConfig, Trainer, TransformerLM
    from horovod_tpu_torch.ops import flash_attention as fa
    model = TransformerLM(cfg, seed=0)
    if on_model is not None:
        on_model(model)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    sync = GradSyncConfig(**{"op": "average", "compression": "bf16",
                             **(sync_kw or {})})
    trainer = Trainer(model, opt, mesh, sync=sync, batch_spec=batch_spec)
    state = trainer.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()                 # the leg's path starts
    losses, step_ms = [], []
    steps = sum(PARALLEL_STEPS)
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = fa.launch_counts()            # ... and ends
    out = {"params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "step_ms": step_ms,
           "timed_step_ms_mean":
               statistics.mean(step_ms[PARALLEL_STEPS[0]:]),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "launches_per_step": {n: c / steps for n, c in launches.items()}}
    del trainer, state, opt, model
    torch.cuda.empty_cache()
    return out


def _parallel_checks(leg: str, out: dict, per_step: int | dict
                     ) -> list[str]:
    """Finite, falling losses and ``per_step`` launches of each flash
    kernel a step (one count for all, or one a kernel)."""
    problems = []
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"parallel ({leg}): a loss is not finite")
    elif not losses[-1] < losses[0]:
        problems.append(f"parallel ({leg}): the loss did not fall")
    steps = sum(PARALLEL_STEPS)
    for name, c in out["launches"].items():
        want = per_step[name] if isinstance(per_step, dict) else per_step
        if c != want * steps:
            problems.append(f"parallel ({leg}): {name} launched {c} times "
                            f"in {steps} steps, not {want} a step")
    return problems


def _remat_launches(layers: int) -> dict:
    """Flash launches a step with every block checkpointed: the forward
    runs again in the backward, under either policy."""
    return {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}


def _view_recorder(model, record: dict) -> None:
    """Count the block calls that ran outside the Trainer's global view,
    and those that ran on another thread than this one (autograd's
    device thread, where a checkpointed block recomputes)."""
    from horovod_tpu_torch.parallel.mesh import current_global_batch
    main = threading.get_ident()
    record.update(calls=0, outside_view=0, other_thread=0)

    def hook(module, args):
        record["calls"] += 1
        record["outside_view"] += current_global_batch() is None
        record["other_thread"] += threading.get_ident() != main
    for block in model.layers:
        block.register_forward_pre_hook(hook)


def _max_loss_diff(a: list[float], b: list[float]) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def _moe_layer_check() -> dict:
    """One fp32 MoE layer at gpt_small's width on the card against the
    same weights and tokens on the CPU (TF32 is off)."""
    from horovod_tpu_torch.models.moe import MoEMLP
    gen = torch.Generator().manual_seed(7)
    layer = MoEMLP(768, num_experts=PARALLEL_MOE["experts"], d_ff=3072,
                   device=torch.device("cpu"))
    layer.router.reset_parameters(gen)
    layer.reset_parameters(gen)
    x = torch.randn(2, 256, 768, generator=gen)
    with torch.no_grad():
        ref = layer(x)
        card = layer.to("cuda")(x.cuda()).cpu()
    err = (card - ref).abs().max().item()
    scale = ref.abs().max().item()
    return {"tokens": 512, "max_abs_err": err, "max_abs_ref": scale,
            "tol": PARALLEL_MOE_CHECK_REL * scale,
            "ok": err <= PARALLEL_MOE_CHECK_REL * scale}


def _parallel_one_card(problems: list[str]) -> dict:
    """Legs (a)-(c) over a one-rank NCCL group on card 0."""
    from horovod_tpu_torch import build_mesh, gpt_small, synthetic_text_batch
    legs: dict[str, dict] = {}
    with _one_rank_nccl():
        mesh = build_mesh(sp=1)
        vocab = 50304
        # (a) Ulysses at sp=1 against flash on the same batch.
        batch = synthetic_text_batch(8, 2048, vocab, seed=0)
        for name, attention in (("flash", "flash"), ("ulysses", "ulysses")):
            cfg = gpt_small(attention=attention, max_seq_len=2048, mesh=mesh)
            legs[name] = _parallel_train(cfg, batch, mesh)
            legs[name].update(batch=8, seq=2048)
            problems += _parallel_checks(name, legs[name], cfg.num_layers)
        legs["ulysses"]["losses_bitwise_equal_flash"] = \
            legs["ulysses"]["losses"] == legs["flash"]["losses"]
        if not legs["ulysses"]["losses_bitwise_equal_flash"]:
            problems.append("parallel (a): Ulysses at sp=1 and flash give "
                            "other losses")
        # (b) the ring at sp=1 (local attention, fp32) against dense.
        batch = synthetic_text_batch(PARALLEL_RING_BATCH, 2048, vocab,
                                     seed=1)
        for name, attention in (("dense", "dense"), ("ring", "ring")):
            cfg = gpt_small(attention=attention, max_seq_len=2048, mesh=mesh)
            legs[name] = _parallel_train(cfg, batch, mesh)
            legs[name].update(batch=PARALLEL_RING_BATCH, seq=2048)
            problems += _parallel_checks(name, legs[name], 0)
        diff = _max_loss_diff(legs["ring"]["losses"], legs["dense"]["losses"])
        legs["ring"]["loss_max_abs_diff_dense"] = diff
        if diff > PARALLEL_LOSS_TOL:
            problems.append(f"parallel (b): ring and dense losses differ by "
                            f"{diff}")
        # (c) MoE in the manual and the pure-GSPMD step.
        moe = PARALLEL_MOE
        batch = synthetic_text_batch(moe["batch"], moe["seq"], vocab,
                                     seed=2)
        cfg = gpt_small(attention="flash", max_seq_len=moe["seq"],
                        moe_experts=moe["experts"], mesh=mesh)
        for name, sync_kw in (("moe-manual", None),
                              ("moe-gspmd", {"axes": ()})):
            legs[name] = _parallel_train(cfg, batch, mesh, sync_kw)
            legs[name].update(batch=moe["batch"], seq=moe["seq"],
                              experts=moe["experts"])
            problems += _parallel_checks(name, legs[name], cfg.num_layers)
        legs["moe-gspmd"]["losses_bitwise_equal_manual"] = \
            legs["moe-gspmd"]["losses"] == legs["moe-manual"]["losses"]
        if not legs["moe-gspmd"]["losses_bitwise_equal_manual"]:
            problems.append("parallel (c): the manual and pure-GSPMD MoE "
                            "steps differ at one rank")
        # (e) (c)'s pure-GSPMD step with every block checkpointed: each
        # recompute must run in the step's global view.
        for policy in REMAT_POLICIES:
            name, record = f"moe-gspmd-remat-{policy}", {}
            rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
            legs[name] = _parallel_train(
                rcfg, batch, mesh, {"axes": ()},
                on_model=lambda m, r=record: _view_recorder(m, r))
            legs[name].update(batch=moe["batch"], seq=moe["seq"],
                              experts=moe["experts"], block_calls=record)
            problems += _parallel_checks(name, legs[name],
                                         _remat_launches(cfg.num_layers))
            want = 2 * cfg.num_layers * sum(PARALLEL_STEPS)
            if record["calls"] != want or record["outside_view"]:
                problems.append(f"parallel (e) {name}: {record} block "
                                f"calls, not {want} all inside the view")
            diff = _max_loss_diff(legs[name]["losses"],
                                  legs["moe-gspmd"]["losses"])
            legs[name]["loss_max_abs_diff_no_remat"] = diff
            if diff > PARALLEL_LOSS_TOL:
                problems.append(f"parallel (e) {name}: losses {diff} from "
                                f"(c)'s")
    legs["moe-layer"] = _moe_layer_check()
    if not legs["moe-layer"]["ok"]:
        problems.append(f"parallel (c): the fp32 MoE layer on the card is "
                        f"{legs['moe-layer']['max_abs_err']} from the CPU's")
    torch.cuda.empty_cache()
    return legs


def parallel_card_worker(rank: int, n: int, port: int, outdir: str) -> int:
    """One rank of leg (d), on card ``rank`` over NCCL: Ulysses and the
    ring at sp=n (each rank its sequence chunk, sync over sp), MoE at
    ep=n in the pure-GSPMD step (each rank its row block), without and
    with every block checkpointed."""
    import torch.distributed as dist
    from horovod_tpu_torch import build_mesh, gpt_small, synthetic_text_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", port, n, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=rank, world_size=n,
                            device_id=torch.device("cuda", rank))
    out = {}
    try:
        vocab = 50304
        for name, attention, b, seed in (
                ("ulysses", "ulysses", 8, 0),
                ("ring", "ring", PARALLEL_RING_BATCH, 1)):
            mesh = build_mesh(sp=n)
            full = synthetic_text_batch(b, 2048, vocab, seed=seed)
            c = 2048 // n
            batch = {k: v[:, rank * c:(rank + 1) * c].contiguous()
                     for k, v in full.items()}
            cfg = gpt_small(attention=attention, max_seq_len=2048, mesh=mesh)
            out[name] = _parallel_train(cfg, batch, mesh,
                                        {"axes": ("dp", "sp")},
                                        batch_spec=("dp", "sp"))
        moe = PARALLEL_MOE
        mesh = build_mesh(ep=n)
        full = synthetic_text_batch(moe["batch"], moe["seq"], vocab, seed=2)
        rows = moe["batch"] // n
        batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in full.items()}
        cfg = gpt_small(attention="flash", max_seq_len=moe["seq"],
                        moe_experts=moe["experts"], mesh=mesh)
        out["moe-gspmd"] = _parallel_train(cfg, batch, mesh, {"axes": ()},
                                           batch_spec=("ep",))
        out["moe-gspmd-remat-full"] = _parallel_train(
            dataclasses.replace(cfg, remat=True), batch, mesh, {"axes": ()},
            batch_spec=("ep",))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _parallel_cards(legs: dict, problems: list[str]) -> dict:
    """Leg (d): with n >= 2 cards, one process a card over NCCL, the
    losses against the one-card legs'."""
    n = torch.cuda.device_count()
    if n < 2:
        return {"not_run": f"the machine shows {n} card"}
    if 12 % n or PARALLEL_MOE["batch"] % n or PARALLEL_MOE["experts"] % n:
        return {"not_run": f"{n} cards do not divide the heads, the MoE "
                           f"batch and the experts"}
    outdir = tempfile.mkdtemp(prefix="parallel")
    port = _free_port()
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--parallel-card-worker", str(r), str(n),
         str(port), outdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(n)]
    t0 = time.perf_counter()
    texts = []
    for p in procs:
        try:
            texts.append(p.communicate(timeout=PARALLEL_WORLD_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            texts.append(p.communicate()[0])
    result = {"cards": n, "wall_s": time.perf_counter() - t0}
    if any(p.returncode != 0 for p in procs):
        problems.append("parallel (d): " + " | ".join(
            t[-2000:] for p, t in zip(procs, texts) if p.returncode != 0))
        return result
    ranks = []
    for r in range(n):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for name, per_step in (("ulysses", 12), ("ring", 0), ("moe-gspmd", 12),
                           ("moe-gspmd-remat-full", _remat_launches(12))):
        one = legs[name]
        rec = {"losses": ranks[0][name]["losses"],
               "timed_step_ms_mean": [x[name]["timed_step_ms_mean"]
                                      for x in ranks],
               "peak_memory_bytes": [x[name]["peak_memory_bytes"]
                                     for x in ranks],
               "launches_per_step": ranks[0][name]["launches_per_step"],
               "loss_max_abs_diff_one_card":
                   _max_loss_diff(ranks[0][name]["losses"], one["losses"])}
        result[name] = rec
        if any(x[name]["losses"] != rec["losses"] for x in ranks):
            problems.append(f"parallel (d) {name}: the ranks' losses differ")
        if rec["loss_max_abs_diff_one_card"] > PARALLEL_LOSS_TOL:
            problems.append(f"parallel (d) {name}: losses "
                            f"{rec['loss_max_abs_diff_one_card']} from the "
                            f"one-card leg's")
        problems += _parallel_checks(f"d {name}", ranks[0][name], per_step)
    return result


def phase_parallel(train: dict | None = None) -> dict:
    """Sequence and expert parallelism on the card (see the module's
    docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    legs = _parallel_one_card(problems)
    for name, leg in legs.items():
        emit({"phase": "parallel", "leg": name, **leg})
    cards = _parallel_cards(legs, problems)
    emit({"phase": "parallel", "leg": "cards", **cards})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "parallel", "leg": "summary", "seconds": seconds,
          "train_timed_step_ms_mean": None if train is None
          else train["timed_step_ms_mean"],
          "step_ms": {name: leg["timed_step_ms_mean"]
                      for name, leg in legs.items()
                      if "timed_step_ms_mean" in leg},
          "peak_memory_bytes": {name: leg["peak_memory_bytes"]
                                for name, leg in legs.items()
                                if "peak_memory_bytes" in leg},
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": legs["ulysses"]["launches"]}


# ---------------------------------------------------------------------------
# The fit phase: Trainer.fit with its callbacks, the loader's card
# pipeline, checkpoints and ring checkpoints, the profiler hooks, and
# cross-replica BatchNorm
# ---------------------------------------------------------------------------
FIT_ROWS, FIT_BATCH, FIT_SEQ, FIT_VOCAB = 64, 8, 2048, 50304
FIT_EPOCHS, FIT_STEPS = 2, 4                 # epochs, steps an epoch
FIT_LR, FIT_WD = 3e-4, 1e-4
FIT_PROFILED_STEPS = 2
FIT_BN_BATCH, FIT_BN_STEPS = 128, 2
HOST_LINK_BYTES_PER_S = 64e9                 # PCIe 5.0 x16, one direction


def _fit_events(epochs: int, steps: int) -> list:
    """The callback events of the reference's ``Trainer.fit``
    (``horovod_tpu/training.py:443-512``) for one callback that has
    ``set_state``."""
    events = [("set_trainer",), ("set_state",), ("train_begin",)]
    for epoch in range(epochs):
        events.append(("epoch_begin", epoch))
        for i in range(steps):
            events += [("batch_begin", i), ("batch_end", i)]
        events += [("set_state",), ("epoch_end", epoch)]
    return events + [("train_end",)]


def _fit_recorder(trainer_opt=None):
    """A callback recording the events, the optimizer's lr and the loss
    tensor at each batch, and the host clock at each batch's start and
    at each epoch's end (after the fit loop's one read of the epoch's
    sums, before any later callback's work)."""
    from horovod_tpu_torch.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            self.events, self.lrs, self.losses = [], [], []
            self.t_begin, self.t_end = {}, {}

        def set_trainer(self, trainer):
            super().set_trainer(trainer)
            self.events.append(("set_trainer",))

        def set_state(self, state):
            self.state = state
            self.events.append(("set_state",))

        def on_train_begin(self, logs=None):
            self.events.append(("train_begin",))

        def on_train_end(self, logs=None):
            self.events.append(("train_end",))

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch
            self.events.append(("epoch_begin", epoch))

        def on_batch_begin(self, batch, logs=None):
            if batch == 0:
                self.t_begin[self.epoch] = time.perf_counter()
            opt = self.state.optimizer
            self.lrs.append(opt.param_groups[0]["lr"])
            self.events.append(("batch_begin", batch))

        def on_batch_end(self, batch, logs=None):
            self.losses.append(logs["loss"])
            self.events.append(("batch_end", batch))

        def on_epoch_end(self, epoch, logs=None):
            self.t_end[epoch] = time.perf_counter()
            self.events.append(("epoch_end", epoch))

        def step_ms(self, epoch):
            return (self.t_end[epoch] - self.t_begin[epoch]) * 1e3 \
                / FIT_STEPS

        def loss_values(self):
            return [x.item() for x in self.losses]
    return Recorder()


class _WaitTimer:
    """The time the fit loop waits in ``next()`` for each batch of the
    pipeline it wraps (host clock)."""

    def __init__(self, it):
        self.it, self.waits = iter(it), []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        self.waits.append((time.perf_counter() - t0) * 1e3)
        return batch


def _fit_dataset() -> dict:
    import numpy as np
    tokens = np.random.default_rng(7).integers(
        0, FIT_VOCAB, (FIT_ROWS, FIT_SEQ + 1), dtype=np.int32)
    return {"input": np.ascontiguousarray(tokens[:, :-1]),
            "label": np.ascontiguousarray(tokens[:, 1:])}


def _fit_pipeline(waits: list):
    """``data(epoch)`` for ``fit``: the loader (shuffled, seed 0) through
    its producer thread and ``prefetch_to_device(size=2)``; each epoch's
    waits are appended to ``waits``."""
    from horovod_tpu_torch.data import (AsyncDataLoaderMixin,
                                        ShardedBatchLoader,
                                        prefetch_to_device)

    class Loader(AsyncDataLoaderMixin, ShardedBatchLoader):
        pass
    loader = Loader(_fit_dataset(), batch_size=FIT_BATCH, seed=0,
                    async_loader_queue_size=4)

    def data(epoch):
        loader.set_epoch(epoch)
        timer = _WaitTimer(prefetch_to_device(loader, size=2))
        waits.append(timer.waits)
        return timer
    return data, loader


def _gpt_trainer(seed: int, ring: bool = False):
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_small)
    cfg = gpt_small(attention="flash", max_seq_len=FIT_SEQ)
    model = TransformerLM(cfg, seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=FIT_LR,
                            weight_decay=FIT_WD)
    trainer = Trainer(model, opt, build_mesh(dp=1),
                      sync=GradSyncConfig(op="average", compression="bf16",
                                          optimizer_in_ring=ring))
    return trainer, trainer.init()


def _params_equal(model, ref: list) -> bool:
    return all(torch.equal(p.detach(), r)
               for p, r in zip(model.parameters(), ref))


def _fit_main(tmp: str, problems: list[str]) -> dict:
    """Legs (a), (d) and the plain loop, then (b) on the same batches."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.callbacks import (BestModelCheckpoint,
                                             LearningRateScheduleCallback,
                                             MetricAverageCallback)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.statesync import state_digest

    trainer, state = _gpt_trainer(seed=0)
    waits: list = []
    data, loader = _fit_pipeline(waits)
    rec = _fit_recorder()
    saves = []

    def timed_save(path, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, st)
        saves.append({"path": path, "ms": (time.perf_counter() - t0) * 1e3})
    callbacks = [LearningRateScheduleCallback(trainer.optimizer,
                                              multiplier=0.5, start_epoch=1),
                 rec, MetricAverageCallback(),
                 BestModelCheckpoint(os.path.join(tmp, "best-{epoch}"),
                                     save_fn=timed_save)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()                      # the main path starts
    t0 = time.perf_counter()
    state, history = trainer.fit(state, data, epochs=FIT_EPOCHS,
                                 callbacks=callbacks,
                                 steps_per_epoch=FIT_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = fa.launch_counts()                 # ... and ends
    steps = FIT_EPOCHS * FIT_STEPS
    losses = rec.loss_values()
    final = [p.detach().clone() for p in trainer.model.parameters()]
    n_params = sum(p.numel() for p in final)
    a = {"phase": "fit", "leg": "a-fit", "model": "gpt_small",
         "params": n_params, "batch": FIT_BATCH, "seq": FIT_SEQ,
         "dtype": "bfloat16", "wire": "bf16", "rows": FIT_ROWS,
         "epochs": FIT_EPOCHS, "steps_per_epoch": FIT_STEPS,
         "losses": losses, "history": history, "lrs": rec.lrs,
         "fit_s": fit_s,
         "epoch_step_ms": [rec.step_ms(e) for e in range(FIT_EPOCHS)],
         "fit_step_ms": rec.step_ms(FIT_EPOCHS - 1),
         "batch_wait_ms": waits,
         "batch_wait_ms_mean": statistics.mean(waits[-1]),
         "checkpoint_saves": saves,
         "peak_memory_bytes": torch.cuda.max_memory_allocated(),
         "launches": launches,
         "launches_per_step": {n: c / steps for n, c in launches.items()}}
    if not all(math.isfinite(x) for x in losses):
        problems.append("fit (a): a loss is not finite")
    if not losses[-1] < losses[0]:
        problems.append("fit (a): the loss did not fall")
    if rec.events != _fit_events(FIT_EPOCHS, FIT_STEPS):
        problems.append(f"fit (a): callback events {rec.events}")
    want_lrs = [FIT_LR] * FIT_STEPS + [FIT_LR * 0.5] * FIT_STEPS
    if rec.lrs != want_lrs:
        problems.append(f"fit (a): lrs {rec.lrs}, not {want_lrs}")
    for name, count in launches.items():
        if count != 12 * steps:
            problems.append(f"fit (a): {name} launched {count} times, not "
                            f"12 a step")
    if [os.path.basename(s["path"]) for s in saves] \
            != [f"best-{e}" for e in range(FIT_EPOCHS)]:
        problems.append(f"fit (a): BestModelCheckpoint saved {saves}")

    # The plain loop: Trainer.step over epoch 1's batches, already on
    # the card.
    loader.set_epoch(FIT_EPOCHS - 1)
    on_card = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b, _ in zip(loader, range(FIT_STEPS))]
    trainer.step(state, on_card[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in on_card:
        state, _ = trainer.step(state, b)
    torch.cuda.synchronize()
    a["plain_step_ms"] = (time.perf_counter() - t0) * 1e3 / FIT_STEPS
    a["fit_over_plain"] = a["fit_step_ms"] / a["plain_step_ms"]
    emit(a)

    d = _fit_profile(trainer, state, data, a, problems)
    del trainer, state, on_card, callbacks, rec
    torch.cuda.empty_cache()

    # (b): a fresh model and optimizer, the epoch-0 checkpoint restored
    # into them, epoch 1 run again.
    best0 = os.path.join(tmp, "best-0")
    trainer, state = _gpt_trainer(seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(best0, target=state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    image_path = os.path.join(best0, checkpoint.IMAGE)
    nbytes = os.path.getsize(image_path)
    image = bytearray(nbytes)
    with open(image_path, "rb") as f:
        f.readinto(image)
    t0 = time.perf_counter()
    state_digest(image)
    digest_ms = (time.perf_counter() - t0) * 1e3
    del image
    rec_b = _fit_recorder()
    fa.reset_launch_counts()
    trainer.fit(state, lambda e: data(FIT_EPOCHS - 1), epochs=1,
                callbacks=[LearningRateScheduleCallback(
                    trainer.optimizer, multiplier=0.5), rec_b],
                steps_per_epoch=FIT_STEPS)
    torch.cuda.synchronize()
    b_launches = fa.launch_counts()
    unbroken = losses[FIT_STEPS:]
    resumed = rec_b.loss_values()
    save_ms = saves[0]["ms"]
    b = {"phase": "fit", "leg": "b-resume", "bytes": nbytes,
         "save_ms": save_ms, "restore_ms": restore_ms,
         "digest_ms": digest_ms,
         "save_gb_per_s": nbytes / save_ms / 1e6,
         "restore_gb_per_s": nbytes / restore_ms / 1e6,
         "host_link_bound_ms": nbytes / HOST_LINK_BYTES_PER_S * 1e3,
         "step": state.step, "losses": resumed, "unbroken_losses": unbroken,
         "losses_bitwise": resumed == unbroken,
         "params_bitwise": _params_equal(trainer.model, final),
         "lrs": rec_b.lrs, "launches": b_launches}
    emit(b)
    if not (b["losses_bitwise"] and b["params_bitwise"]):
        problems.append("fit (b): the resumed epoch is not the unbroken "
                        "run's, bitwise")
    if any(c != 12 * FIT_STEPS for c in b_launches.values()):
        problems.append(f"fit (b): launches {b_launches}")
    del trainer, state, final
    torch.cuda.empty_cache()
    return {"a": a, "b": b, "d": d}


def _fit_profile(trainer, state, data, a: dict, problems: list[str]) -> dict:
    """Leg (d): two more steps of (a) through ``fit`` inside
    ``start_profiler``/``stop_profiler``, each step inside
    ``profiler_annotation("fit_step")`` (entered at the batch's start,
    left at its end, by a callback)."""
    import glob
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import Callback

    class Annotate(Callback):
        def __init__(self):
            self.ends = []

        def on_batch_begin(self, batch, logs=None):
            self.ctx = hvd.profiler_annotation("fit_step")
            self.ctx.__enter__()

        def on_batch_end(self, batch, logs=None):
            self.ctx.__exit__(None, None, None)
            torch.cuda.synchronize()       # each step's own time
            self.ends.append(time.perf_counter())

    logdir = tempfile.mkdtemp(prefix="fit_trace")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    annotate = Annotate()
    hvd.start_profiler(logdir)
    trainer.fit(state, lambda e: data(FIT_EPOCHS), epochs=1,
                callbacks=[annotate], steps_per_epoch=FIT_PROFILED_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / FIT_PROFILED_STEPS
    t1 = time.perf_counter()
    hvd.stop_profiler()
    stop_s = time.perf_counter() - t1
    traces = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    ends = [t0] + annotate.ends
    d = {"phase": "fit", "leg": "d-profiler", "traces": len(traces),
         "profiled_step_ms": step_ms,
         "profiled_step_ms_each": [(b - a) * 1e3
                                   for a, b in zip(ends, ends[1:])],
         "stop_and_write_s": stop_s,
         "profiler_cost": step_ms / a["fit_step_ms"] - 1}
    if len(traces) != 1:
        problems.append(f"fit (d): {len(traces)} trace files")
        emit(d)
        return d
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    d["trace_bytes"] = os.path.getsize(traces[0])
    d["annotations"] = sum(1 for e in events if e.get("name") == "fit_step"
                           and e.get("ph") == "X")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    d["cuda_kernel_events"] = len(kernels)
    d["flash_kernel_events"] = {
        n: sum(1 for e in kernels if n + "_kernel" in e.get("name", ""))
        for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    d["h2d_copies"] = len(h2d)
    d["h2d_device_ms_per_step"] = sum(e.get("dur", 0) for e in h2d) / 1e3 \
        / FIT_PROFILED_STEPS
    d["h2d_bytes"] = sum(e.get("args", {}).get("bytes", 0) for e in h2d)
    emit(d)
    shutil.rmtree(logdir, ignore_errors=True)
    if d["annotations"] < FIT_PROFILED_STEPS:
        problems.append(f"fit (d): {d['annotations']} fit_step annotations")
    if not kernels or not all(d["flash_kernel_events"].values()):
        problems.append(f"fit (d): the trace holds no CUDA kernel of some "
                        f"flash kernel ({d['flash_kernel_events']})")
    return d


def _fit_ring(tmp: str, problems: list[str]) -> dict:
    """Leg (c): (b) with the optimizer in the ring at a world of one,
    through save_ring_checkpoint and restore_ring_checkpoint."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.callbacks import (Callback,
                                             LearningRateScheduleCallback)
    from horovod_tpu_torch.ops import flash_attention as fa

    ck, ring_dir = os.path.join(tmp, "ring-ck"), os.path.join(tmp, "ring")
    timing = {}

    class SaveAfterEpoch0(Callback):
        def set_state(self, state):
            self.state = state

        def on_epoch_end(self, epoch, logs=None):
            if epoch:
                return
            st = self.state
            n = sum(p.numel() for p in st.model.parameters())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(ck, st)
            t1 = time.perf_counter()
            checkpoint.save_ring_checkpoint(ring_dir, st.optimizer, rank=0,
                                            world=1, n_params=n,
                                            step=st.step)
            timing.update(save_ms=(t1 - t0) * 1e3,
                          ring_save_ms=(time.perf_counter() - t1) * 1e3)

    waits: list = []
    data, _ = _fit_pipeline(waits)
    trainer, state = _gpt_trainer(seed=0, ring=True)
    rec = _fit_recorder()
    state, _ = trainer.fit(state, data, epochs=FIT_EPOCHS, callbacks=[
        LearningRateScheduleCallback(trainer.optimizer, multiplier=0.5,
                                     start_epoch=1), rec, SaveAfterEpoch0()],
        steps_per_epoch=FIT_STEPS)
    torch.cuda.synchronize()
    losses = rec.loss_values()
    final = [p.detach().clone() for p in trainer.model.parameters()]
    ring_lrs = rec.lrs
    del trainer, state
    torch.cuda.empty_cache()

    trainer, state = _gpt_trainer(seed=1, ring=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(ck, target=state)
    t1 = time.perf_counter()
    _, step = checkpoint.restore_ring_checkpoint(ring_dir, state.optimizer,
                                                 rank=0, world=1)
    torch.cuda.synchronize()
    timing.update(restore_ms=(t1 - t0) * 1e3,
                  ring_restore_ms=(time.perf_counter() - t1) * 1e3)
    rec_c = _fit_recorder()
    fa.reset_launch_counts()
    trainer.fit(state, lambda e: data(FIT_EPOCHS - 1), epochs=1,
                callbacks=[LearningRateScheduleCallback(
                    trainer.optimizer, multiplier=0.5), rec_c],
                steps_per_epoch=FIT_STEPS)
    torch.cuda.synchronize()
    resumed = rec_c.loss_values()
    c = {"phase": "fit", "leg": "c-ring-resume",
         "bytes": os.path.getsize(os.path.join(ck, checkpoint.IMAGE)),
         "ring_bytes": os.path.getsize(os.path.join(ring_dir,
                                                    "ring-0-of-1.state")),
         **timing, "ring_step": step, "losses": resumed,
         "unbroken_losses": losses[FIT_STEPS:],
         "losses_bitwise": resumed == losses[FIT_STEPS:],
         "params_bitwise": _params_equal(trainer.model, final),
         "lrs": ring_lrs, "resumed_lrs": rec_c.lrs,
         "launches": fa.launch_counts()}
    emit(c)
    if not (c["losses_bitwise"] and c["params_bitwise"]):
        problems.append("fit (c): the ring's resumed epoch is not the "
                        "unbroken run's, bitwise")
    if ring_lrs[-1] != FIT_LR * 0.5 or rec_c.lrs[-1] != FIT_LR * 0.5:
        problems.append(f"fit (c): lrs {ring_lrs} / {rec_c.lrs}")
    if any(n != 12 * FIT_STEPS for n in c["launches"].values()):
        problems.append(f"fit (c): launches {c['launches']}")
    del trainer, state, final
    torch.cuda.empty_cache()
    return c


def _fit_bn_leg(axis_name, batch: dict, state0: dict) -> dict:
    from horovod_tpu_torch import ResNet50
    model = ResNet50(dtype=torch.float32, axis_name=axis_name, seed=0)
    model.load_state_dict(state0)
    out = bn_steps(model, batch, FIT_BN_STEPS)
    del model
    torch.cuda.empty_cache()
    return out


def _fit_cross_replica_bn(problems: list[str]) -> dict:
    """Leg (e): ResNet-50, fp32, B=128, ``axis_name="dp"`` beside
    ``axis_name=None`` on a one-rank NCCL mesh, from the same weights and
    batch: logits of a train-mode forward, then two SGD(0.1, 0.9) steps
    (the first also warms up), their losses and times, the parameters
    after each and the statistics after both.  At one rank the axis has
    one member: no all-reduce runs, as XLA drops a one-member psum.

    The parameters are held after each step to the larger of the cnn
    phase's 1e-5 and the plain leg's own sensitivity to its input, the
    distance to the plain leg run on images moved by one ulp
    (``x·(1 + 2^-23)``): two fp32 BatchNorms that are not bitwise one
    cannot be closer than that."""
    from horovod_tpu_torch import ResNet50, synthetic_image_batch
    state0 = {k: v.clone() for k, v in
              ResNet50(dtype=torch.float32, seed=0).state_dict().items()}
    batch = synthetic_image_batch(FIT_BN_BATCH, 224, seed=3)
    plain = _fit_bn_leg(None, batch, state0)
    cross = _fit_bn_leg("dp", batch, state0)
    moved = _fit_bn_leg(None, {"image": batch["image"] * (1 + 2.0 ** -23),
                               "label": batch["label"]}, state0)
    e = {"phase": "fit", "leg": "e-cross-replica-bn", "model": "ResNet50",
         "dtype": "float32", "batch": FIT_BN_BATCH, "image_size": 224,
         "steps": FIT_BN_STEPS,
         "logits_rel_err": _rel_err(cross["logits"], plain["logits"]),
         "loss_rel_err": max(abs(x - y) / abs(y) for x, y in
                             zip(cross["losses"], plain["losses"])),
         "stats_max_abs_err": _max_err(cross["stats"], plain["stats"]),
         "params_max_abs_err": [_max_err(c, p) for c, p in
                                zip(cross["params"], plain["params"])],
         "params_one_ulp_sensitivity": [_max_err(m, p) for m, p in
                                        zip(moved["params"],
                                            plain["params"])],
         "losses": cross["losses"], "plain_losses": plain["losses"],
         "step_ms": cross["step_ms"], "plain_step_ms": plain["step_ms"],
         "timed_step_ms": cross["step_ms"][-1],
         "plain_timed_step_ms": plain["step_ms"][-1]}
    emit(e)
    bounds = {"logits_rel_err": CNN_LOGITS_REL,
              "loss_rel_err": CNN_LOGITS_REL,
              "stats_max_abs_err": CNN_STATS_TOL}
    problems += [f"fit (e): {k} {e[k]} over {bound}"
                 for k, bound in bounds.items() if not e[k] <= bound]
    for step, (err, floor) in enumerate(zip(
            e["params_max_abs_err"], e["params_one_ulp_sensitivity"])):
        if not err <= max(CNN_PARAMS_TOL, floor):
            problems.append(f"fit (e): parameters after step {step + 1} "
                            f"{err} apart, over {CNN_PARAMS_TOL} and the "
                            f"one-ulp sensitivity {floor}")
    return e


def phase_fit() -> dict:
    """The fit loop and its state on the card (see the module's
    docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    tmp = tempfile.mkdtemp(prefix="fit")
    try:
        with _one_rank_nccl():
            main = _fit_main(tmp, problems)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            ring = _fit_ring(tmp, problems)
            bn = _fit_cross_replica_bn(problems)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b, d = main["a"], main["b"], main["d"]
    seconds = time.perf_counter() - t_phase
    emit({"phase": "fit", "leg": "summary", "seconds": seconds,
          "fit_step_ms": a["fit_step_ms"], "plain_step_ms": a["plain_step_ms"],
          "batch_wait_ms_mean": a["batch_wait_ms_mean"],
          "h2d_device_ms_per_step": d.get("h2d_device_ms_per_step"),
          "save_ms": b["save_ms"], "restore_ms": b["restore_ms"],
          "digest_ms": b["digest_ms"], "checkpoint_bytes": b["bytes"],
          "ring_save_ms": ring.get("ring_save_ms"),
          "ring_restore_ms": ring.get("ring_restore_ms"),
          "profiled_step_ms": d["profiled_step_ms"],
          "bn_cross_step_ms": bn["timed_step_ms"],
          "bn_plain_step_ms": bn["plain_timed_step_ms"],
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": a["launches"]}


# ---------------------------------------------------------------------------
# statesync: elastic membership without a restart, on the one card
# ---------------------------------------------------------------------------
SS_BEFORE_STEPS = 3                     # incumbent steps before the join
SS_GROWN_STEPS = 3                      # steps of the grown world
SS_AFTER_STEPS = 3                      # survivor steps after the departure
# The joiner's SIGTERM: chaos fires on the grown world's third digest
# exchange, so the departure lands at the boundary after grown step 3.
SS_PREEMPT = f"preempt:rank=1,name=ss.grown.{SS_GROWN_STEPS}"
SS_GRACE_S = 60.0
SS_FAULT_TIMEOUT = 60.0                 # a 762 MB host allreduce fits
SS_WORLD_TIMEOUT = 300.0
SS_GO = ("chipss", "go")                # the joiners' start signal
# Leg (c): the resilience phase's fp32 serving ranks; two waves, the
# joiner signalled once the first wave's first third is served.
SS_SERVE = dict(SERVE_TIMED, requests=24, max_new=32)
SS_SERVE_GO_AFTER = 8
SS_SERVE_WAVE2 = 12
# Leg (d): distinct prompts, so no prefix hit admits one locally.
SS_DISAGG = dict(SERVE_TIMED, requests=16, pool=16, max_new=32, seed=8)
# One token's K and V in every layer of gpt_small in bf16 (the image a
# prefill streams): 12 layers x 2 x 768 x 2 bytes.
SS_KV_BYTES_PER_TOKEN = 12 * 2 * 768 * 2


def _ss_env(role: str, outdir: str) -> dict:
    env = {"HOROVOD_SHM_OPERATIONS": "0",
           "HOROVOD_FLIGHT_FILE": os.path.join(outdir, f"flight-{role}.json"),
           # Deep enough to keep the membership events of a run whose
           # every step records hundreds (one a gradient).
           "HOROVOD_FLIGHT_EVENTS": str(1 << 16),
           "HOROVOD_STATESYNC_TIMEOUT_SECONDS": "120",
           "HOROVOD_GLOO_TIMEOUT_SECONDS": "120"}
    if role.startswith("cp3"):
        # The control-plane phase's grow 3 -> 4 over the replica set: the
        # rendezvous primary killed at the incumbents' second exchange.
        env.update(HOROVOD_FAULT_TOLERANCE="1",
                   HOROVOD_FAULT_TIMEOUT=str(SS_FAULT_TIMEOUT),
                   HOROVOD_RENDEZVOUS_EPOCH="cpgrow")
        if role == "cp3":
            env["HOROVOD_CHAOS"] = CP_CARDS_KILL
    elif role.startswith("train2"):
        # The grow 2 -> 3 of the cards phase: no preemption.
        env.update(HOROVOD_FAULT_TOLERANCE="1",
                   HOROVOD_FAULT_TIMEOUT=str(SS_FAULT_TIMEOUT),
                   HOROVOD_RENDEZVOUS_EPOCH="sstrain2")
    elif role.startswith("train"):
        env.update(HOROVOD_FAULT_TOLERANCE="1",
                   HOROVOD_FAULT_TIMEOUT=str(SS_FAULT_TIMEOUT),
                   HOROVOD_PREEMPT_GRACE_S=str(SS_GRACE_S),
                   HOROVOD_CHAOS=SS_PREEMPT,
                   HOROVOD_RENDEZVOUS_EPOCH="sstrain")
    elif role.startswith("serve"):
        env.update(HOROVOD_FAULT_TOLERANCE="1", HOROVOD_FAULT_TIMEOUT="30",
                   HOROVOD_RENDEZVOUS_EPOCH="ssserve")
    else:
        env.update(HOROVOD_RENDEZVOUS_EPOCH="ssdisagg")
    return env


def _ss_train_state(seed: int):
    """gpt_small as the elastic phase's user loop trains it: flash, bf16
    compute, AdamW(3e-4, wd 1e-4), held in a ``TrainState``."""
    from horovod_tpu_torch import TransformerLM, gpt_small
    from horovod_tpu_torch.training import TrainState
    cfg = gpt_small(attention="flash", max_seq_len=2048)
    model = TransformerLM(cfg, seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    return TrainState(step=0, model=model, optimizer=opt)


def _ss_train_step(hvd, core, state, batch,
                   host_dtype: torch.dtype | None = None) -> dict:
    """One step of the user loop: forward, backward, the gradients
    averaged through ``hvd`` (on the card where the core has a plane on
    it, a world of one; else host copies over the TCP ring, the API's
    rule for CUDA tensors in a world of ranks sharing a card, cast to
    ``host_dtype`` on the card first when it is given), AdamW."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss
    model, opt = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loss = cross_entropy_loss(model(batch["input"], train=True),
                              batch["label"])
    loss.backward()
    grads = [p.grad for p in params]
    on_card = hvd.size() == 1 or core.global_state().device_plane
    name = f"ss.grads.{state.step}"
    if on_card:
        outs = hvd.grouped_allreduce(grads, op=hvd.Average, name=name)
        for g, o in zip(grads, outs):
            g.copy_(o)
    else:
        host = [g.detach().to(host_dtype or g.dtype).cpu() for g in grads]
        outs = hvd.grouped_allreduce(host, op=hvd.Average, name=name)
        for g, o in zip(grads, outs):
            g.copy_(o, non_blocking=True)
    opt.step()
    opt.zero_grad(set_to_none=True)
    state.step += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"step": state.step, "size": hvd.size(), "ms": ms,
            "loss": loss.item(), "launches": fa.launch_counts(),
            "plane": "card" if on_card else "host (TCP ring)",
            "device_plane": core.global_state().device_plane,
            "device": str(grads[0].device), "t_end": time.time()}


def _ss_digest(hvd, state, name: str) -> dict:
    """The state's digest on every rank (``allgather_object``)."""
    from horovod_tpu_torch import statesync
    from horovod_tpu_torch.checkpoint import train_state_tree
    t0 = time.perf_counter()
    digest = statesync.state_digest(
        statesync.flatten_state(train_state_tree(state)))
    views = hvd.allgather_object(digest, name=name)
    return {"name": name, "digests": views,
            "equal": len(set(views)) == 1,
            "ms": (time.perf_counter() - t0) * 1e3}


def _ss_train_rank(role: str, port: int, outdir: str) -> dict:
    """Legs (a) and (b), one process: the incumbent (``train``, a world
    of one) or the joiner (``train-joiner``); or, in the cards phase, an
    incumbent of a world of two (``train2``) or its joiner
    (``train2-joiner``), which stop together after the grown world's
    steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import (core, resilience, statesync,
                                   synthetic_text_batch)
    from horovod_tpu_torch.checkpoint import (load_train_state,
                                              train_state_tree)
    from horovod_tpu_torch.runner.network import RendezvousClient
    from horovod_tpu_torch.statesync import service as ss_service
    from horovod_tpu_torch.telemetry import flight
    kv = RendezvousClient(os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"], port,
                          120.0)
    rec: dict = {"role": role, "steps": [], "boundary_ms": [],
                 "digests": [], "snapshots": []}

    class TimedSnapshot(statesync.Snapshot):
        """The boundary's flatten and digest, timed."""
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            rec["snapshots"].append(
                {"ms": (time.perf_counter() - t0) * 1e3,
                 "bytes": len(self.data), "step": self.stamp.step})
    ss_service.Snapshot = TimedSnapshot
    joiner = role.endswith("joiner")
    two = role.startswith(("train2", "cp3"))
    state = _ss_train_state(seed=1 if joiner else 0)
    rank_seed = 1 if joiner else 0
    batch = synthetic_text_batch(8, 2048, state.model.cfg.vocab_size,
                                 seed=rank_seed)
    grown = None
    if joiner:
        template = train_state_tree(state)
        kv.wait(*SS_GO, SS_WORLD_TIMEOUT)
        rec["t_announce"] = time.time()
        tree, info = statesync.join_world(template)
        rec["t_entered"] = time.time()
        load_train_state(tree, state)
        del tree, template
        torch.cuda.synchronize()
        rec["t_loaded"] = time.time()
        rec["join"] = {"rank": info.rank, "size": info.size,
                       "catch_up_ms": info.catch_up_ms,
                       "bulk_bytes": info.bulk_bytes,
                       "bulk_gb_per_s": info.bulk_bytes
                       / (info.catch_up_ms * 1e6),
                       "donor_stats": info.donor_stats,
                       "stamp": info.stamp.as_meta(), "step": state.step}
        rec["joined_digest_equals_stamp"] = statesync.state_digest(
            statesync.flatten_state(train_state_tree(state))) \
            == info.stamp.digest
        grown = 0
    else:
        hvd.init()
    svc = statesync.StateSyncService(lambda: train_state_tree(state))
    if joiner:
        rec["digests"].append(_ss_digest(hvd, state, "ss.grown.0"))
    posted, after = False, None
    deadline = time.monotonic() + SS_WORLD_TIMEOUT
    while time.monotonic() < deadline:
        donating = any(d.is_alive() for d in svc._donors.values())
        step = _ss_train_step(hvd, core, state, batch)
        step["donating"] = donating
        rec["steps"].append(step)
        if grown is not None and hvd.size() > 1:
            grown += 1
            rec["digests"].append(_ss_digest(hvd, state,
                                             f"ss.grown.{grown}"))
            if two and grown == SS_GROWN_STEPS:
                break
        prev_epoch = os.environ["HOROVOD_RENDEZVOUS_EPOCH"]
        t0 = time.perf_counter()
        change = svc.step_boundary()
        rec["boundary_ms"].append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after += 1
        if change is None:
            pass
        elif change.kind == "grow":
            grown = 0
            rec["grow"] = {"join": change.join_id, "size": change.size,
                           "step": state.step, "t": time.time(),
                           "boundary_ms": rec["boundary_ms"][-1]}
            rec["digests"].append(_ss_digest(hvd, state, "ss.grown.0"))
        elif change.kind == "departed":
            raw = kv.get("hb", f"{prev_epoch}:1")
            rec["departed"] = {
                "step": state.step,
                "bye": raw is not None and raw.startswith(b"bye|"),
                "t_sigterm": time.time()
                - (time.monotonic() - svc._preempt_at)}
            break
        elif change.kind == "shrink":
            res = resilience.active_state()
            rec["shrink"] = {
                "dead": list(change.dead), "size": change.size,
                "step": state.step, "t": time.time(),
                "failed_ranks": sorted(res.failed_ranks())
                if res is not None else [],
                "device_stream": core.global_state().device_stream
                is not None,
                "epoch": os.environ["HOROVOD_RENDEZVOUS_EPOCH"]}
            grown, after = None, 0
        if not joiner and not posted and state.step >= SS_BEFORE_STEPS:
            kv.put(*SS_GO, b"1")
            posted = True
        if after is not None and after >= SS_AFTER_STEPS:
            break
    rec["flight"] = [ev["kind"] for ev in flight.recorder().snapshot()
                     if ev["kind"] in ("shrink", "donate", "grow",
                                       "join-announce", "join-ready",
                                       "join-entered", "sigterm-grace",
                                       "departed", "shrink-proactive",
                                       "ranks-failed", "mark-failed")]
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    svc.close()
    hvd.shutdown()
    return rec


def _ss_serve_rank(role: str, rank: int, port: int, outdir: str) -> dict:
    """Leg (c), one process: an incumbent serving rank (``serve``) or the
    joiner (``serve-joiner``), fp32 gpt_small on the card."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import TransformerLM, gpt_small, statesync
    from horovod_tpu_torch.runner.network import RendezvousClient
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    from horovod_tpu_torch.serving import replica as rep
    from horovod_tpu_torch.serving.loadgen import _goodput_phases
    kv = RendezvousClient("127.0.0.1", port, 120.0)
    scfg = ServeConfig(model_cfg=gpt_small(dtype=torch.float32),
                       **SS_SERVE["cfg"])
    rec: dict = {"role": role}
    seed = rep.serving_params_template(scfg)    # the seed's, on the host
    if role == "serve-joiner":
        infos = []
        join_world = statesync.join_world

        def recorded_join(*args, **kwargs):
            out = join_world(*args, **kwargs)
            infos.append(out[1])
            return out
        statesync.join_world = recorded_join
        kv.wait(*SS_GO, SS_WORLD_TIMEOUT)
        rec["t_announce"] = time.time()
        ex = rep.join_serving_world(scfg, device="cuda")
        rec["t_entered"] = time.time()
        info = infos[0]
        rec["join"] = {"rank": info.rank, "size": info.size,
                       "catch_up_ms": info.catch_up_ms,
                       "bulk_bytes": info.bulk_bytes,
                       "bulk_gb_per_s": info.bulk_bytes
                       / (info.catch_up_ms * 1e6)}
        rec["params_are_seed_plus_quarter"] = all(
            torch.equal(t.cpu(), seed[k] + 0.25)
            for k, t in ex.state_tree().items())
        ex.serve_loop()
        ex._stop_requested = False
        ex.serve_loop()
        rec.update(rank=ex.rank, size=ex.size,
                   completed=len(ex.completed))
        ex.statesync.close()
    else:
        hvd.init()
        base = TransformerLM(rep._serving_model_cfg(scfg), device="cpu",
                             seed=scfg.seed)
        params = {k: v + 0.25 for k, v in base.state_dict().items()}
        del base
        ex = ReplicaExecutor(scfg, params=params, device="cuda")
        service = statesync.StateSyncService(state_provider=ex.state_tree,
                                             static_state=True)
        ex.attach_statesync(service)
        prompts = _prompt_pool(SS_SERVE, scfg.model_cfg.vocab_size)

        def wave(n: int, first: int) -> None:
            for i in range(n):
                ex.stats["offered"] += 1
                ex.queue.submit(prompts[(first + i) % len(prompts)],
                                SS_SERVE["max_new"])
        posted = []

        def until_grown() -> bool:
            # Called on the front only, once a loop turn.
            if not posted and ex.stats["served"] >= SS_SERVE_GO_AFTER:
                kv.put(*SS_GO, b"1")
                posted.append(time.time())
            return bool(ex.stats["grows"])
        hvd.barrier()
        t0 = time.monotonic()
        if rank == 0:
            wave(SS_SERVE["requests"], 0)
        ex.serve_loop(stop_when=until_grown)
        ex._stop_requested = False
        if ex.rank == ex.front:
            wave(SS_SERVE_WAVE2, SS_SERVE["requests"])
        ex.serve_loop(stop_when=lambda: True)
        wall = time.monotonic() - t0
        st = ex.stats
        rec.update(rank=ex.rank, size=ex.size, served=st["served"],
                   offered=st["offered"], lost=st["lost"],
                   expired=st["expired"], grows=st["grows"],
                   shrinks=st["shrinks"], gen=ex._gen, wall_s=wall,
                   goodput_phases=_goodput_phases(ex, wall))
        service.close()
    ex.close()
    hvd.shutdown()
    return rec


def _ss_disagg_rank(rank: int, outdir: str) -> dict:
    """Leg (d), one process: a rank of the disaggregated world, bf16
    gpt_small paged, rank 1 prefill-only."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import TransformerLM, gpt_small, telemetry
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    hvd.init()
    cfg = gpt_small()
    ex = ReplicaExecutor(ServeConfig(model_cfg=cfg, paged=True,
                                     prefill_ranks=1, **SS_DISAGG["cfg"]),
                         params=TransformerLM(cfg, seed=0).state_dict(),
                         device="cuda")
    streams, rid_prompt, ttft = {}, {}, {}
    collect = ex._collect_completions
    land = ex._land_streamed

    def record():
        for s in ex.slots:
            if s is not None and s.pending is None and s.remaining == 0:
                streams[s.rid] = list(s.generated)
        collect()

    def landed(slot, img):
        land(slot, img)
        s = ex.slots[slot]
        ttft[s.rid] = s.age_ms + (time.monotonic() - s.assigned_at) * 1e3
    ex._collect_completions = record
    ex._land_streamed = landed
    send = ex._kvstream.send_image if ex.is_prefill else None
    sends = []

    def timed_send(rid, dests, image, **meta):
        t0 = time.perf_counter()
        send(rid, dests, image, **meta)
        sends.append((memoryview(image).nbytes,
                      (time.perf_counter() - t0) * 1e3, meta["plen"]))
    if send is not None:
        ex._kvstream.send_image = timed_send
    hvd.barrier()
    if rank == 0:
        for prompt in _prompt_pool(SS_DISAGG, cfg.vocab_size):
            ex.stats["offered"] += 1
            rid_prompt[ex.queue.submit(prompt, SS_DISAGG["max_new"])] = \
                prompt
    t0 = time.perf_counter()
    ex.serve_loop(stop_when=lambda: True)
    torch.cuda.synchronize()
    rec = {"rank": rank, "wall_s": time.perf_counter() - t0,
           "served": ex.stats["served"], "offered": ex.stats["offered"],
           "prefill_streams": ex.stats["prefill_streams"],
           "prefill_fallbacks": ex.stats["prefill_fallbacks"],
           "streams": {str(k): v for k, v in streams.items()},
           "prompts": {str(k): v for k, v in rid_prompt.items()},
           "ttft_ms": {str(k): v for k, v in ttft.items()},
           "sends": sends,
           "sent_bytes": telemetry.metrics().counter(
               "horovod_serve_prefill_stream_bytes_total",
               labels={"role": "sent"}).value}
    ex.close()
    hvd.barrier()
    hvd.shutdown()
    return rec


def statesync_worker(role: str, rank: int, size: int, port: int,
                     outdir: str) -> int:
    """``chip_smoke.py --statesync-worker ROLE RANK SIZE PORT OUTDIR``:
    one process of the statesync phase on the card; its record goes to
    ``OUTDIR/<role>_<rank>.json``.  No card: exit 3."""
    if not torch.cuda.is_available():
        print("statesync worker: no CUDA device", file=sys.stderr)
        return 3
    if os.environ.get("CHIP_SMOKE_CARD"):
        torch.cuda.set_device(int(os.environ["CHIP_SMOKE_CARD"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ.update(HOROVOD_GLOO_RENDEZVOUS_ADDR=os.environ.get(
                          "CHIP_SMOKE_SEEDS", "127.0.0.1"),
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      **_ss_env(role, outdir))
    if not role.endswith("joiner"):
        os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size))
    if role.startswith(("train", "cp3")):
        rec = _ss_train_rank(role, port, outdir)
    elif role.startswith("serve"):
        rec = _ss_serve_rank(role, rank, port, outdir)
    else:
        rec = _ss_disagg_rank(rank, outdir)
    with open(os.path.join(outdir, f"{role}_{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _ss_world(jobs: list[tuple], outdir: str,
              seeds: list[str] | None = None) -> list[dict]:
    """Start every (role, rank, size) process at once against one
    RendezvousServer (or the replica set of the ``seeds`` list), each
    with the cards visible (a fourth element: the card the process makes
    current); wait for all within SS_WORLD_TIMEOUT and return their
    records."""
    from horovod_tpu_torch.runner.network import RendezvousServer
    server = None
    if seeds is None:
        server = RendezvousServer()
        port = server.start()
    else:
        port = int(seeds[0].rsplit(":", 1)[1])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    if seeds is not None:
        env["CHIP_SMOKE_SEEDS"] = ",".join(seeds)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--statesync-worker",
         role, str(rank), str(size), str(port), outdir],
        env={**env, **{"CHIP_SMOKE_CARD": str(c) for c in card}},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for role, rank, size, *card in jobs]
    failures = []
    t_end = time.monotonic() + SS_WORLD_TIMEOUT
    try:
        for (role, rank, *_), p in zip(jobs, procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"{role} {rank} timed out")
            if p.returncode != 0:
                failures.append(f"{role} {rank} rc={p.returncode}: "
                                + out.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if server is not None:
            server.stop()
    if failures:
        raise RuntimeError("statesync world: " + "; ".join(failures))
    out = []
    for role, rank, *_ in jobs:
        with open(os.path.join(outdir, f"{role}_{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _ss_launches_ok(steps: list[dict], layers: int) -> bool:
    return all(set(s["launches"].values()) == {layers} and
               len(s["launches"]) == 3 for s in steps)


def _ss_training(problems: list[str], cards: bool = False) -> dict:
    """Legs (a) and (b): the grow 1 -> 2 of gpt_small's user loop by peer
    streaming, then the joiner's preemption and the proactive shrink.
    ``cards``: the incumbent on card 0 and the joiner on card 1, so that
    the grown world averages on the NCCL plane."""
    from horovod_tpu_torch import gpt_small
    layers = gpt_small().num_layers
    phase = "cards" if cards else "statesync"
    jobs = [("train", 0, 1, 0), ("train-joiner", 0, 0, 1)] if cards \
        else [("train", 0, 1), ("train-joiner", 0, 0)]
    with tempfile.TemporaryDirectory(prefix="sstrain") as outdir:
        inc, joi = _ss_world(jobs, outdir)
    steps = inc["steps"]
    grow = inc.get("grow") or {}
    shrink = inc.get("shrink") or {}
    before = [s for s in steps if s["size"] == 1 and not s["donating"]
              and s["step"] <= grow.get("step", 0)]
    during = [s for s in steps if s["donating"] and s["size"] == 1]
    grown = [s for s in steps if s["size"] == 2]
    after = [s for s in steps if s["step"] > shrink.get("step", 1 << 30)]
    bstall = inc["boundary_ms"]
    join = joi.get("join", {})
    first_grown = next((s for s in joi["steps"] if s["size"] == 2), None)
    snaps = inc["snapshots"]
    a = {"phase": phase, "leg": "a-train-grow", "model": "gpt_small",
         "batch": 8, "seq": 2048, "dtype": "bfloat16", "ranks": "1->2",
         "card": "cards 0 and 1, one a process" if cards
         else "one H100 shared by both processes",
         "catch_up_ms": join.get("catch_up_ms"),
         "bulk_bytes": join.get("bulk_bytes"),
         "bulk_gb_per_s": join.get("bulk_gb_per_s"),
         "donor_stats": join.get("donor_stats"),
         "snapshots": snaps,
         "boundary_stall_ms": {
             "donation_start": max((b for b, s in zip(bstall, steps)
                                    if s in before[-1:]), default=None),
             "grow": grow.get("boundary_ms"),
             "steady_p50": statistics.median(bstall)},
         "step_ms_before": [s["ms"] for s in before],
         "step_ms_during_donation": [s["ms"] for s in during],
         "steps_during_donation": len(during),
         "join_wall_s": None if first_grown is None
         else first_grown["t_end"] - joi["t_announce"],
         "join_to_entered_s": joi["t_entered"] - joi["t_announce"],
         "grown_step_ms": {"incumbent": [s["ms"] for s in grown],
                           "joiner": [s["ms"] for s in joi["steps"]
                                      if s["size"] == 2]},
         "grown_plane": sorted({s["plane"] for s in grown}),
         "grown_device_plane": [s.get("device_plane") for s in grown]
         + [s.get("device_plane") for s in joi["steps"]
            if s["size"] == 2],
         "devices": sorted({s.get("device") for s in steps}
                           | {s.get("device") for s in joi["steps"]}),
         "digests": [(d["name"], d["equal"]) for d in inc["digests"]],
         "digest_ms": [d["ms"] for d in inc["digests"]],
         "joined_digest_equals_stamp": joi.get("joined_digest_equals_stamp"),
         "losses": [s["loss"] for s in steps],
         "joiner_losses": [s["loss"] for s in joi["steps"]],
         "launches_per_step": steps[0]["launches"] if steps else None,
         "incumbent_steps": len(steps),
         "peak_memory_bytes": {"incumbent": inc["peak_memory_bytes"],
                               "joiner": joi["peak_memory_bytes"]},
         "flight": {"incumbent": inc["flight"], "joiner": joi["flight"]}}
    emit(a)
    dep = joi.get("departed") or {}
    first_after = after[0] if after else None
    b = {"phase": phase, "leg": "b-preempt-grace", "ranks": "2->1",
         "grace_s": SS_GRACE_S, "chaos": SS_PREEMPT,
         "departed": dep, "shrink": shrink,
         "sigterm_to_survivor_first_step_s": None
         if not dep or first_after is None
         else first_after["t_end"] - dep["t_sigterm"],
         "after_step_ms": [s["ms"] for s in after],
         "after_plane": sorted({s["plane"] for s in after}),
         "after_losses": [s["loss"] for s in after],
         "launches_after": [s["launches"] for s in after]}
    emit(b)
    tag = "cards statesync" if cards else "statesync"
    if not grow or grow.get("size") != 2:
        problems.append(f"{tag} (a): no grow to 2: {grow}")
    if not a["joined_digest_equals_stamp"]:
        problems.append(f"{tag} (a): the joiner's image is not the stamp's")
    if len(grown) != SS_GROWN_STEPS:
        problems.append(f"{tag} (a): {len(grown)} grown steps")
    digests = inc["digests"] + joi["digests"]
    if not digests or not all(d["equal"] for d in digests) \
            or len(inc["digests"]) != SS_GROWN_STEPS + 1:
        problems.append(f"{tag} (a): digests {a['digests']}")
    losses = a["losses"] + a["joiner_losses"]
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"{tag} (a): a loss is not finite")
    if not _ss_launches_ok(steps, layers) \
            or not _ss_launches_ok(joi["steps"], layers):
        problems.append(f"{tag} (a/b): flash launches not {layers} of each "
                        f"kernel on every step")
    if a["grown_plane"] != (["card"] if cards else ["host (TCP ring)"]):
        problems.append(f"{tag} (a): grown plane {a['grown_plane']}")
    if cards and (not all(a["grown_device_plane"])
                  or a["devices"] != ["cuda:0", "cuda:1"]):
        problems.append(f"{tag} (a): the grown world's NCCL plane "
                        f"{a['grown_device_plane']} on {a['devices']}")
    if not (dep.get("bye") and dep.get("step") == grow.get("step", 0)
            + SS_GROWN_STEPS):
        problems.append(f"{tag} (b): departure {dep}")
    if shrink.get("dead") != [1] or shrink.get("size") != 1 \
            or shrink.get("failed_ranks") or not shrink.get("device_stream"):
        problems.append(f"{tag} (b): shrink {shrink}")
    kinds = inc["flight"]
    if "ranks-failed" in kinds or "mark-failed" in kinds \
            or [k for k in kinds if k != "done"] != \
            ["donate", "grow", "shrink-proactive"]:
        problems.append(f"{tag} (a/b): incumbent flight {kinds}")
    if joi["flight"] != ["join-announce", "join-ready", "join-entered",
                         "sigterm-grace", "departed"]:
        problems.append(f"{tag} (a/b): joiner flight {joi['flight']}")
    if len(after) != SS_AFTER_STEPS or b["after_plane"] != ["card"]:
        problems.append(f"{tag} (b): after the shrink {len(after)} steps "
                        f"on {b['after_plane']}")
    launches = {}
    for s in steps:
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "a": a, "b": b}


def _ss_serving(problems: list[str], cards: bool = False) -> dict:
    """Leg (c): the serving grow 2 -> 3 on the card (``cards``: each
    process on a card of its own, 0, 1 and the joiner's 2)."""
    jobs = [("serve", 0, 2), ("serve", 1, 2), ("serve-joiner", 0, 0)]
    if cards:
        jobs = [job + (card,) for card, job in enumerate(jobs)]
    tag = "cards statesync" if cards else "statesync"
    with tempfile.TemporaryDirectory(prefix="ssserve") as outdir:
        r0, r1, joi = _ss_world(jobs, outdir)
    grows = r0["grows"]
    line = {"phase": "cards" if cards else "statesync",
            "leg": "c-serve-grow", "model": "gpt_small", "dtype": "float32",
            "ranks": "2->3",
            "card": "cards 0, 1 and 2, one a process" if cards
            else "one H100 shared by the three processes",
            "served": r0["served"], "offered": r0["offered"],
            "lost": r0["lost"], "expired": r0["expired"], "grows": grows,
            "goodput_phases": r0["goodput_phases"], "wall_s": r0["wall_s"],
            "catch_up_ms": joi["join"]["catch_up_ms"],
            "bulk_bytes": joi["join"]["bulk_bytes"],
            "bulk_gb_per_s": joi["join"]["bulk_gb_per_s"],
            "join_to_entered_s": joi["t_entered"] - joi["t_announce"],
            "joiner": {"rank": joi["rank"], "size": joi["size"],
                       "completed": joi["completed"]},
            "params_are_seed_plus_quarter":
                joi["params_are_seed_plus_quarter"]}
    emit(line)
    want = SS_SERVE["requests"] + SS_SERVE_WAVE2
    if not (r0["served"] == r0["offered"] == want and not r0["lost"]
            and not r0["expired"]):
        problems.append(f"{tag} (c): served {r0['served']} of "
                        f"{r0['offered']}, lost {r0['lost']}, expired "
                        f"{r0['expired']}")
    if [(g["from"], g["to"]) for g in grows] != [(2, 3)] or r0["shrinks"]:
        problems.append(f"{tag} (c): grows {grows}")
    if not joi["params_are_seed_plus_quarter"]:
        problems.append(f"{tag} (c): the streamed params are not the "
                        "incumbents'")
    return line


def _ss_disagg(problems: list[str], cards: bool = False) -> dict:
    """Leg (d): disaggregated prefill at 2 ranks against a colocated
    one-rank paged run of the same requests in this process (``cards``:
    the decode rank on card 0, the prefill rank on card 1)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import TransformerLM, gpt_small
    jobs = [("disagg", 0, 2, 0), ("disagg", 1, 2, 1)] if cards \
        else [("disagg", 0, 2), ("disagg", 1, 2)]
    tag = "cards statesync" if cards else "statesync"
    with tempfile.TemporaryDirectory(prefix="ssdisagg") as outdir:
        r0, r1 = _ss_world(jobs, outdir)
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    cfg = gpt_small()
    model = TransformerLM(cfg, seed=0)
    hvd.init()
    try:
        # The colocated run: the same weights and requests, one rank.
        ex = ReplicaExecutor(ServeConfig(model_cfg=cfg, paged=True,
                                         **SS_DISAGG["cfg"]),
                             params=model.state_dict(), device="cuda")
        want, colo_ttft = {}, []
        collect, activate = ex._collect_completions, ex._activate_slot

        def record():
            for sl in ex.slots:
                if sl is not None and sl.remaining == 0:
                    want[sl.rid] = list(sl.generated)
            collect()

        def activated(slot, a, now, first, **kw):
            activate(slot, a, now, first, **kw)
            colo_ttft.append(a.age_ms + (time.monotonic() - now) * 1e3)
        ex._collect_completions, ex._activate_slot = record, activated
        for prompt in _prompt_pool(SS_DISAGG, cfg.vocab_size):
            ex.stats["offered"] += 1
            ex.queue.submit(prompt, SS_DISAGG["max_new"])
        t0 = time.perf_counter()
        ex.serve_loop(stop_when=lambda: True)
        torch.cuda.synchronize()
        colo_wall = time.perf_counter() - t0
        del ex._collect_completions, ex._activate_slot
        ex.close()
    finally:
        hvd.shutdown()
    got = {int(k): v for k, v in r0["streams"].items()}
    prompts = {int(k): v for k, v in r0["prompts"].items()}
    differ = sorted(r for r in got if got[r] != want.get(r))
    check = None
    if differ:
        # The serve phase's rule: where a stream parts from the colocated
        # run's, each token must score within NEAR_ARGMAX of the full
        # forward's maximum.
        check = _near_argmax(model, {r: got[r] for r in differ}, prompts)
    del model
    torch.cuda.empty_cache()
    kv_bytes = [b for b, _, _ in r1["sends"]]
    plens = [p for _, _, p in r1["sends"]]
    ms = [m for _, m, _ in r1["sends"]]
    ttft = sorted(r0["ttft_ms"].values())
    colo_ttft.sort()
    line = {"phase": "cards" if cards else "statesync",
            "leg": "d-disagg-prefill",
            "model": "gpt_small", "dtype": "bfloat16", "ranks": 2,
            "card": "decode on card 0, prefill on card 1" if cards
            else "one H100 shared by both processes",
            "served": r0["served"], "offered": r0["offered"],
            "prefill_streams": r1["prefill_streams"],
            "prefill_fallbacks": r0["prefill_fallbacks"],
            "kv_bytes_per_request_mean": statistics.fmean(kv_bytes)
            if kv_bytes else None,
            "kv_bytes_per_prompt_token": sum(kv_bytes) / max(1, sum(plens)),
            "kv_bytes_per_token": sum(kv_bytes) / max(1, sum(
                -(-p // SS_DISAGG["cfg"]["block_tokens"])
                * SS_DISAGG["cfg"]["block_tokens"] for p in plens)),
            "stream_ms_per_mb": sum(ms) / (sum(kv_bytes) / 1e6)
            if kv_bytes else None,
            "ttft_ms": {"p50": ttft[len(ttft) // 2] if ttft else None,
                        "max": ttft[-1] if ttft else None},
            "colocated": {"ttft_ms": {
                "p50": colo_ttft[len(colo_ttft) // 2] if colo_ttft
                else None, "max": colo_ttft[-1] if colo_ttft else None},
                "wall_s": colo_wall},
            "wall_s": r0["wall_s"], "streams_equal": len(got) - len(differ),
            "streams_differ": differ, "near_argmax": check}
    emit(line)
    n = SS_DISAGG["requests"]
    if not (r0["served"] == n and r1["prefill_streams"] == n
            and r0["prefill_fallbacks"] == 0):
        problems.append(f"{tag} (d): served {r0['served']}, streamed "
                        f"{r1['prefill_streams']}, fallbacks "
                        f"{r0['prefill_fallbacks']} of {n}")
    if sorted(got) != sorted(want) or (check and check["beyond_tolerance"]):
        problems.append(f"{tag} (d): streams {differ} part from the "
                        f"colocated run's: {check}")
    if line["kv_bytes_per_token"] != SS_KV_BYTES_PER_TOKEN:
        problems.append(f"{tag} (d): {line['kv_bytes_per_token']} KV "
                        f"bytes a token")
    return line


def phase_statesync() -> dict:
    """Elastic membership without a restart (see the module docstring)."""
    t_phase = time.perf_counter()
    problems: list[str] = []
    train = _ss_training(problems)
    _ss_serving(problems)
    _ss_disagg(problems)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "statesync", "leg": "summary", "seconds": seconds,
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": train["launches"]}


# ---------------------------------------------------------------------------
# The cards phase: the data-parallel main path across the cards of one
# host, one process a card under the port's launcher
# ---------------------------------------------------------------------------
# The sizes of the phase: gpt_small at B=8, T=2048 (the train phase's), the
# reference benchmark's ResNet-50 at B=128 and 224x224, the binding legs'
# plane and SyncBatchNorm inputs.  The CPU rehearsal of the phase
# (tests/torch_cards_rehearsal.py) puts small sizes here.
CARDS = dict(gpt="gpt_small", batch=8, seq=2048,
             resnet=dict(stage_sizes=(3, 4, 6, 3), num_filters=64,
                         num_classes=1000),
             image=224, cnn_batch=128, plane_rows=1000,
             fused_bytes=BINDING_FUSED_BYTES, stream_tensors=16,
             stream_elements=(1 << 20) // 4, syncbn_shape=(8, 64, 28, 28),
             statesync=True)
CARDS_BACKEND = "nccl"                  # the plane's process group
CARDS_PARITY_STEPS = 3
CARDS_STEPS = (WARMUP_STEPS, TIMED_STEPS)
CARDS_WIRE_STEPS = (2, 3)               # warm-up, timed (the sync phase's)
CARDS_BN_STEPS = 2
CARDS_LR, CARDS_WD = 3e-4, 1e-4
# dp=n against one card on the same global batch.  The first step is a
# forward on the same weights: the rows' bf16 logits differ only where
# cuBLAS picks another kernel for another row count, and the mean of
# 16,384 fp32 losses moves far less than one bf16 ulp of a logit (2^-8
# of its size).  Later steps also carry the gradients' other summation
# order (bf16 partial sums on the wire) through AdamW, whose first steps
# move each weight by about lr whatever the gradient's size; the parallel
# phase's sp=n legs hold the same kind of distance to PARALLEL_LOSS_TOL.
CARDS_FIRST_LOSS_TOL = 5e-3
CARDS_LOSS_TOL = PARALLEL_LOSS_TOL
# A wire's losses at n cards are held to the bf16 wire's there within the
# larger of CARDS_LOSS_TOL and the same distance at one card, on the one
# card's own batch.  Neither bounds the other: the wire's rounding feeds
# through AdamW differently on every batch (the ring's most: it gathers
# the parameters on its 16-bit wire, as the reference's ring does).
CARDS_WIRES = (("int8", dict(compression="int8")),
               ("uint4", dict(compression="uint4")),
               ("ring", dict(compression="bf16", optimizer_in_ring=True)))
CARDS_STREAMS = RUNTIME_STREAMS
CARDS_PLANE_VALUES = 16                 # float inputs: integers in +-16
CARDS_WORLD_TIMEOUT = 900.0
# The eager core's cycle in the quiet leg: the background thread then
# negotiates about once a second while the Trainer steps (1 ms is the
# default).
CARDS_QUIET_CYCLE_MS = 1000.0


class _WireCount:
    """While open, the bytes this rank sends through ``torch.distributed``'s
    collectives, by the ring algorithms' count: an all-reduce sends
    2(n-1)/n of its buffer, a reduce-scatter and an all-to-all (n-1)/n of
    their input, an all-gather (n-1)/n of its output."""

    _SENT = {"all_reduce": (0, 2), "reduce_scatter_tensor": (1, 1),
             "all_to_all_single": (1, 1), "all_gather_into_tensor": (0, 1)}

    def __enter__(self):
        import torch.distributed as dist
        self.bytes = self.calls = 0
        self._orig = {}
        for name, (arg, twice) in self._SENT.items():
            orig = getattr(dist, name)
            self._orig[name] = orig

            def counted(*args, _orig=orig, _arg=arg, _twice=twice, **kw):
                n = dist.get_world_size(kw.get("group"))
                t = args[_arg] if len(args) > _arg else \
                    kw["input" if _arg else "tensor"]
                self.bytes += _twice * t.numel() * t.element_size() \
                    * (n - 1) // n
                self.calls += 1
                return _orig(*args, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def _card_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _misplaced(device: torch.device, named) -> list[str]:
    """The names of the tensors in ``named`` (name, tensor) that do not
    lie on ``device``."""
    return [name for name, t in named
            if torch.is_tensor(t) and t.device != device]


def _world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gather_objects(obj) -> list:
    """``obj`` of every rank of the default group (a world of one: this
    rank's)."""
    import torch.distributed as dist
    if _world()[1] == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def cards_train(model, sync_kw: dict, batch: dict, steps: int, *,
                warmup: int = 0, optimizer: str = "adamw",
                digests: bool = False, probe: bool = False,
                profile=None) -> dict:
    """``Trainer.step`` over ``build_mesh(dp=world)`` on this rank's
    ``batch``, with AdamW(3e-4, wd 1e-4) (or SGD(0.1, 0.9)) and
    ``GradSyncConfig(op="average", **sync_kw)``: losses (averaged over dp
    by the step), step ms, the flash launches, peak memory, the optimizer
    state's bytes, and the tensors that do not lie on the model's device
    (parameters, optimizer state, batch).  ``digests``: a SHA-256 of the
    parameters after every step, gathered from every rank.  ``probe``:
    the sync alone on the last step's gradients, timed on the card
    (median of 5), and the bytes this rank sends in one sync.
    ``profile`` (kernel categories): one more step under the profiler on
    the card (``_profile``)."""
    from horovod_tpu_torch import GradSyncConfig, Trainer, build_mesh
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.grad_sync import (sync_and_apply,
                                                      sync_gradients)
    rank, world = _world()
    device = next(model.parameters()).device
    if optimizer == "adamw":
        opt = torch.optim.AdamW(model.parameters(), lr=CARDS_LR,
                                weight_decay=CARDS_WD)
    else:
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sync = GradSyncConfig(**{"op": "average", **sync_kw})
    trainer = Trainer(model, opt, build_mesh(dp=world, device=device),
                      sync=sync)
    state = trainer.init()
    _card_sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launch_counts()                 # the leg's path starts
    losses, step_ms, views = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        _card_sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        if digests:
            views.append(_gather_objects(_params_digest(model)))
    launches = fa.launch_counts()            # ... and ends
    misplaced = _misplaced(device, [
        *model.named_parameters(), *model.named_buffers(),
        *((f"optimizer.{k}", t) for st in state.optimizer.state.values()
          for k, t in st.items() if k != "step"),
        *((f"batch.{k}", v) for k, v in batch.items())])
    timed = step_ms[warmup:]
    out = {"rank": rank, "world": world, "losses": losses,
           "step_ms": step_ms, "timed_step_ms_mean": statistics.mean(timed),
           "launches": launches,
           "launches_per_step": {k: c / steps for k, c in launches.items()},
           "optimizer_state_bytes": _optimizer_bytes(state.optimizer),
           "misplaced": misplaced, "device": str(device)}
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if digests:
        out["digests"] = views
        out["params_equal_every_step"] = all(len(set(v)) == 1
                                             for v in views)
    if profile is not None and device.type == "cuda":
        out["profile"] = _profile(lambda: trainer.step(state, batch),
                                  out["timed_step_ms_mean"], profile)
    if probe:
        params = {n: trainer._params[n] for n in trainer._names}
        grads = {n: p.grad for n, p in params.items()}
        group = trainer._sync_group

        def one_sync():
            if sync.optimizer_in_ring:
                sync_and_apply(state.optimizer, grads, params,
                               trainer._sync, group, trainer._layouts)
            else:
                sync_gradients(grads, trainer._sync, group,
                               trainer._layouts)
        with _WireCount() as wire:
            one_sync()
            _card_sync(device)
        out["wire_bytes"] = wire.bytes
        out["wire_calls"] = wire.calls
        out["gradient_elements"] = sum(p.numel() for p in params.values())
        if device.type == "cuda":
            out["sync_ms"] = time_ms(one_sync, rounds=5, warmup=1)
    del trainer, state, opt
    return out


def bn_steps(model, batch: dict, steps: int) -> dict:
    """fp32 ``Trainer.step`` with SGD(0.1, 0.9) and the fp32 wire over
    ``build_mesh(dp=world)``: the logits of one train-mode forward from
    the model's weights (the statistics then put back), then ``steps``
    steps, their losses and times, the parameters after each (on the
    host) and the statistics after the last."""
    from horovod_tpu_torch import Trainer, build_mesh
    from horovod_tpu_torch.parallel.mesh import manual_region
    _, world = _world()
    device = next(model.parameters()).device
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = Trainer(model, opt, build_mesh(dp=world, device=device))
    state = trainer.init()
    with torch.no_grad(), manual_region(trainer.mesh):
        logits = model(batch["image"], train=True)
    model.load_state_dict(state0)             # the forward moved the stats
    losses, step_ms, params = [], [], []
    for _ in range(steps):
        _card_sync(device)
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        _card_sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        # A copy on the host (on the CPU ``.cpu()`` would alias).
        params.append({k: v.detach().to("cpu", copy=True)
                       for k, v in model.named_parameters()})
    out = {"logits": logits.cpu(), "losses": losses, "step_ms": step_ms,
           "params": params,
           "stats": {k: v.to("cpu", copy=True)
                     for k, v in model.named_buffers()}}
    del trainer, state, opt
    return out


def _cards_gpt(**overrides):
    """The phase's gpt model (seed 0) with flash attention."""
    import horovod_tpu_torch as hvt
    cfg = getattr(hvt, CARDS["gpt"])(attention="flash",
                                     max_seq_len=CARDS["seq"], **overrides)
    return cfg, hvt.TransformerLM(cfg, seed=0)


def _cards_resnet(dtype, axis_name=None):
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    return ResNet(block_cls=BottleneckBlock, dtype=dtype,
                  axis_name=axis_name, seed=0, **CARDS["resnet"])


def _rows(full: dict, rank: int, rows: int) -> dict:
    return {k: v[rank * rows:(rank + 1) * rows].contiguous()
            for k, v in full.items()}


def _batch_digest(batch: dict) -> str:
    import hashlib
    digest = hashlib.sha256()
    for k in sorted(batch):
        digest.update(batch[k].contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return digest.hexdigest()


def _text_batch(rows: int, seed: int) -> dict:
    import horovod_tpu_torch as hvt
    vocab = getattr(hvt, CARDS["gpt"])().vocab_size
    return hvt.synthetic_text_batch(rows, CARDS["seq"], vocab, seed=seed)


def _free() -> None:
    """Give the card's cached blocks back once a leg's objects are gone."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _cards_leg_parity(ctx: dict) -> dict:
    """(1i) dp=n at B/n a rank against one card at B, on the same global
    batch (the train phase's), with the parameters' digests after every
    step."""
    rank, n = ctx["rank"], ctx["n"]
    full = _text_batch(CARDS["batch"], seed=0)
    batch = _rows(full, rank, CARDS["batch"] // n)
    _, model = _cards_gpt()
    out = cards_train(model, {"compression": "bf16"}, batch,
                      CARDS_PARITY_STEPS, digests=True)
    out.update(rows=CARDS["batch"] // n, batch_digest=_batch_digest(full))
    del model
    _free()
    return out


def _cards_leg_gpt(ctx: dict) -> dict:
    """(1ii) B a rank: rank r takes rows [rB, (r+1)B) of a global batch of
    nB drawn from seed 0 (at one rank the train phase's batch); warm-up
    and timed steps, then the sync alone."""
    rank, n = ctx["rank"], ctx["n"]
    batch = _rows(_text_batch(CARDS["batch"] * n, seed=0), rank,
                  CARDS["batch"])
    ctx["gpt_batch"] = batch
    _, model = _cards_gpt()
    out = cards_train(model, {"compression": "bf16"}, batch,
                      sum(CARDS_STEPS), warmup=CARDS_STEPS[0], probe=True,
                      profile=KERNEL_CATEGORIES)
    out.update(rows=CARDS["batch"], seq=CARDS["seq"])
    del model
    _free()
    return out


def _cards_leg_wires(ctx: dict) -> dict:
    """(2) the int8, uint4 and optimizer-in-ring wires on (1ii)'s
    batches."""
    out = {}
    for name, kw in CARDS_WIRES:
        _, model = _cards_gpt()
        out[name] = cards_train(model, kw, ctx["gpt_batch"],
                                sum(CARDS_WIRE_STEPS),
                                warmup=CARDS_WIRE_STEPS[0], probe=True)
        del model
        _free()
    return out


def _cards_resnet_bf16(ctx: dict) -> dict:
    """ResNet-50 in bf16 with local BatchNorm at B a card: rank r takes
    rows [rB, (r+1)B) of a batch of nB images from seed 0."""
    from horovod_tpu_torch import synthetic_image_batch
    rank, n = ctx["rank"], ctx["n"]
    b, classes = CARDS["cnn_batch"], CARDS["resnet"]["num_classes"]
    model = _cards_resnet(torch.bfloat16)
    batch = _rows(synthetic_image_batch(b * n, CARDS["image"], classes,
                                        seed=0), rank, b)
    torch.backends.cudnn.benchmark = True
    try:
        out = cards_train(model, {"compression": "bf16"}, batch,
                          sum(CARDS_STEPS), warmup=CARDS_STEPS[0],
                          optimizer="sgd", profile=CNN_CATEGORIES)
    finally:
        torch.backends.cudnn.benchmark = False
    del model, batch
    _free()
    return out


def _cards_leg_quiet(ctx: dict) -> dict:
    """(1ii) and (3)'s bf16 ResNet-50 once more in a world re-initialised
    with ``HOROVOD_CYCLE_TIME`` at CARDS_QUIET_CYCLE_MS.  The Trainer runs
    no eager op, so what the steps gain here is what the eager core's
    idle negotiation costs them at the default cycle."""
    hvd = ctx["hvd"]
    base = dict(os.environ)
    hvd.shutdown()
    os.environ.update(HOROVOD_RENDEZVOUS_EPOCH="cards.quiet",
                      HOROVOD_CYCLE_TIME=str(CARDS_QUIET_CYCLE_MS))
    hvd.init()
    try:
        out = {"cycle_time_ms": CARDS_QUIET_CYCLE_MS,
               "threads": sorted(t.name for t in threading.enumerate()),
               "gpt": _cards_leg_gpt(ctx),
               "resnet_bf16": _cards_resnet_bf16(ctx)}
    finally:
        hvd.shutdown()
        os.environ.clear()
        os.environ.update(base, HOROVOD_RENDEZVOUS_EPOCH="cards.main")
        hvd.init()
    return out


def _cards_leg_resnet(ctx: dict) -> dict:
    """(3) ResNet-50 in bf16 with local BatchNorm at B a card (scaling),
    then fp32 with cross-replica BatchNorm at B/n a card against one
    card at B (the parent holds them; rank 0 writes its parameters and
    statistics, every rank its logits)."""
    from horovod_tpu_torch import synthetic_image_batch
    rank, n, outdir = ctx["rank"], ctx["n"], ctx["outdir"]
    b, size = CARDS["cnn_batch"], CARDS["image"]
    classes = CARDS["resnet"]["num_classes"]
    out = {"bf16": _cards_resnet_bf16(ctx)}
    full = synthetic_image_batch(b, size, classes, seed=3)
    model = _cards_resnet(torch.float32, axis_name="dp")
    res = bn_steps(model, _rows(full, rank, b // n), CARDS_BN_STEPS)
    torch.save(res["logits"], os.path.join(outdir, f"bn_logits_{rank}.pt"))
    if rank == 0:
        torch.save({"params": res["params"], "stats": res["stats"]},
                   os.path.join(outdir, "bn_state.pt"))
    views = _gather_objects(_params_digest(model))
    out["cross_bn"] = {"losses": res["losses"], "step_ms": res["step_ms"],
                       "rows": b // n, "batch_digest": _batch_digest(full),
                       "params_equal_across_ranks": len(set(views)) == 1}
    del model, res
    _free()
    return out


def _plane_input(shape, dtype: str, seed: int) -> torch.Tensor:
    """A rank's input of one plane case, drawn on the host: floats are
    integers within CARDS_PLANE_VALUES (every sum below is exact), other
    types as the binding phase draws them."""
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    if dtype == "bool":
        return torch.rand(shape, generator=g) < 0.3
    if dt.is_floating_point:
        return torch.randint(-CARDS_PLANE_VALUES, CARDS_PLANE_VALUES + 1,
                             shape, generator=g).to(dt)
    info = torch.iinfo(dt)
    return torch.randint(max(info.min // 4, -2 ** 40),
                         min(info.max // 4, 2 ** 40), shape, generator=g,
                         dtype=torch.int64).to(dt)


def _plane_sum(xs: list, pre: float, post: float) -> torch.Tensor:
    """The plane's allreduce of the ranks' ``xs`` on the host: each input
    prescaled, summed exactly (integers wrap, as NCCL's and numpy's add
    do; a bool sum is logical or), then postscaled."""
    scaled = [_torch_scale(x, pre) for x in xs]
    dt = xs[0].dtype
    if dt == torch.bool:
        total = torch.stack(scaled).any(0)
    elif dt.is_floating_point:
        total = torch.stack([x.double() for x in scaled]).sum(0).to(dt)
    else:
        total = torch.stack([x.long() for x in scaled]).sum(0).to(dt)
    return _torch_scale(total, post)


def _cards_leg_plane(ctx: dict) -> dict:
    """(4) ``NcclBackend`` at n ranks over the world's group, driven with
    responses built as the controller builds them, in every dtype of the
    binding phase, against the same collectives on the host; then a
    fused allreduce timed beside NCCL's all-reduce of the same bytes."""
    import torch.distributed as dist

    from horovod_tpu_torch import native
    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import from_any
    from horovod_tpu_torch.common.message import Response, ResponseType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch.telemetry.perfmodel import busbw_mbps
    rank, n = ctx["rank"], ctx["n"]
    dev = _rank_device()
    calls = dict(native.calls)
    plane = NcclBackend(NcclCommunicator(device=dev))
    rows, k = CARDS["plane_rows"], 5
    fused_shapes = ((7,), (), (64, 64), (33,))
    results: dict[str, bool] = {}
    for i, dt in enumerate(BINDING_DTYPES):
        def draw(shape_of, salt):
            return [_plane_input(shape_of(r), dt, 1000 * salt + 10 * i + r)
                    for r in range(n)]
        base = dict(devices=list(range(n)),
                    tensor_type=from_any(getattr(torch, dt)))

        def run(rtype, xs, splits=(), **kw):
            entries = [TensorTableEntry(tensor_name=f"t{j}",
                                        tensor=t.to(dev))
                       for j, t in enumerate(xs)]
            entries[0].splits = list(splits)
            resp = Response(response_type=rtype,
                            tensor_names=[e.tensor_name for e in entries],
                            **base, **kw)
            if not plane.enabled(resp, entries):
                raise RuntimeError(f"the plane declines {rtype} {dt}")
            plane.execute(resp, entries).raise_if_error()
            return [e.output for e in entries]

        def same(tag, got, want):
            results[f"{tag}_{dt}"] = bool(
                got.device == dev and got.dtype == want.dtype
                and got.shape == want.shape
                and torch.equal(got.cpu(), want))

        ar = ResponseType.ALLREDUCE
        xs = draw(lambda r: (rows, 3), 1)
        for tag, pre, post in (("ar_sum", 1.0, 1.0),
                               ("ar_avg", 1.0, 1.0 / n),
                               ("ar_scaled", 2.0, 0.25)):
            same(tag, run(ar, [xs[rank]], tensor_sizes=[xs[rank].numel()],
                          prescale_factor=pre, postscale_factor=post)[0],
                 _plane_sum(xs, pre, post))
        parts = [draw(lambda r, s=s: s, 2 + j)
                 for j, s in enumerate(fused_shapes)]
        outs = run(ar, [p[rank] for p in parts],
                   tensor_sizes=[p[rank].numel() for p in parts],
                   prescale_factor=2.0, postscale_factor=0.25)
        results[f"ar_fused_{dt}"] = all(
            o.shape == p[rank].shape
            and torch.equal(o.cpu(), _plane_sum(p, 2.0, 0.25))
            for o, p in zip(outs, parts))
        xs = draw(lambda r: (rows + r, 3), 7)
        same("ag", run(ResponseType.ALLGATHER, [xs[rank]],
                       tensor_sizes=[x.shape[0] for x in xs])[0],
             torch.cat(xs))
        outs = run(ResponseType.ALLGATHER, [xs[rank], xs[rank][:0]],
                   tensor_sizes=[x.shape[0] for x in xs] + [0] * n)
        results[f"ag_fused_{dt}"] = torch.equal(outs[0].cpu(),
                                                torch.cat(xs)) \
            and outs[1].shape == (0, 3)
        xs = draw(lambda r: (rows, 3), 8)
        same("bc", run(ResponseType.BROADCAST, [xs[rank]],
                       tensor_sizes=[xs[rank].numel()],
                       root_rank=n - 1)[0], xs[n - 1])
        xs = draw(lambda r: (n * k, 3), 9)
        same("a2a", run(ResponseType.ALLTOALL, [xs[rank]],
                        splits=[k] * n)[0],
             torch.cat([x[rank * k:(rank + 1) * k] for x in xs]))
        same("rs", run(ResponseType.REDUCESCATTER, [xs[rank]],
                       tensor_sizes=[xs[rank].numel()],
                       prescale_factor=2.0, postscale_factor=0.25)[0],
             _plane_sum(xs, 2.0, 0.25)[rank * k:(rank + 1) * k])
    torch.cuda.synchronize()
    # A fused allreduce of 16 fp32 tensors, CARDS["fused_bytes"] in all,
    # and NCCL's all-reduce of one buffer of those bytes.
    nbytes = CARDS["fused_bytes"]
    parts = [torch.randn(nbytes // 64, device=dev) for _ in range(16)]
    entries = [TensorTableEntry(tensor_name=f"f{j}", tensor=t)
               for j, t in enumerate(parts)]
    resp = Response(response_type=ResponseType.ALLREDUCE,
                    tensor_names=[e.tensor_name for e in entries],
                    devices=list(range(n)),
                    tensor_type=from_any(torch.float32),
                    tensor_sizes=[t.numel() for t in parts])
    ms = time_ms(lambda: plane.allreduce(resp, entries), rounds=5,
                 warmup=2)
    flat = torch.cat(parts)
    nccl_ms = time_ms(lambda: dist.all_reduce(flat), rounds=5, warmup=2)
    native_moved = {k2: v - calls.get(k2, 0) for k2, v in
                    native.calls.items() if v != calls.get(k2, 0)}
    return {"ranks": n, "dtypes": list(BINDING_DTYPES),
            "on_card": dev.type == "cuda", "checks": len(results),
            "mismatches": sorted(c for c, ok in results.items() if not ok),
            "fused_allreduce": {
                "bytes": nbytes, "tensors": len(parts), "ms": ms,
                "gb_per_s": nbytes / ms / 1e6,
                "busbw_gb_per_s": busbw_mbps("allreduce", nbytes, ms, n)
                / 1e3,
                "nccl_all_reduce_ms": nccl_ms,
                "nccl_busbw_gb_per_s":
                    busbw_mbps("allreduce", nbytes, nccl_ms, n) / 1e3},
            "native_calls_during": native_moved}


class _StreamCount:
    """The responses each stream's op manager runs, and those of them on
    the device plane."""

    def __init__(self, core) -> None:
        from horovod_tpu_torch.backend.base import is_device_response
        managers = core.global_state().op_managers
        self.responses = [0] * len(managers)
        self.device = [0] * len(managers)
        for s, manager in enumerate(managers):
            inner = manager.execute_operation

            def counted(response, entries, _s=s, _inner=inner):
                self.responses[_s] += 1
                self.device[_s] += is_device_response(response)
                return _inner(response, entries)
            manager.execute_operation = counted


def _cards_leg_streams(ctx: dict) -> dict:
    """(4) Device responses on 1, 2 and 4 streams: the world re-initialised
    with ``HOROVOD_NUM_STREAMS`` and fusion off, CARDS["stream_tensors"]
    fp32 tensors on the card allreduced in one cycle (2 warm-up and 5
    timed bursts), the responses each stream ran."""
    from horovod_tpu_torch.telemetry.perfmodel import busbw_mbps
    hvd, core, rank, n = ctx["hvd"], ctx["core"], ctx["rank"], ctx["n"]
    dev = _rank_device()
    m, count = CARDS["stream_elements"], CARDS["stream_tensors"]
    xs = [torch.full((m,), float(rank + 1 + i), device=dev)
          for i in range(count)]
    want = [float(sum(r + 1 + i for r in range(n))) for i in range(count)]
    base = dict(os.environ)
    out, bad = {}, []
    for streams in CARDS_STREAMS:
        hvd.shutdown()
        os.environ.update(HOROVOD_RENDEZVOUS_EPOCH=f"cards.s{streams}",
                          HOROVOD_NUM_STREAMS=str(streams),
                          HOROVOD_FUSION_THRESHOLD="0")
        hvd.init()
        st = core.global_state()
        counter = _StreamCount(core)

        def burst():
            hs = [hvd.allreduce_async(x, op=hvd.Sum, name=f"s{i}")
                  for i, x in enumerate(xs)]
            for i, h in enumerate(hs):
                o = hvd.synchronize(h)
                if o.device != dev or not bool(o.eq(want[i]).all()):
                    bad.append(f"streams {streams} s{i}: {o.device} "
                               f"{o[:2].tolist()} not {want[i]}")
        for _ in range(2):
            burst()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            burst()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        nbytes = count * m * 4
        out[f"streams{streams}"] = {
            "ms": ms, "gb_per_s": nbytes / ms / 1e6,
            "busbw_gb_per_s": busbw_mbps("allreduce", nbytes, ms, n) / 1e3,
            "device_plane": st.device_plane, "on_card": dev.type == "cuda",
            "active_streams": st.active_streams,
            "responses_by_stream": counter.responses,
            "device_responses_by_stream": counter.device}
    hvd.shutdown()
    os.environ.clear()
    os.environ.update(base, HOROVOD_RENDEZVOUS_EPOCH="cards.binding")
    hvd.init()
    out["problems"] = bad
    out["bytes"] = count * m * 4
    return out


def _cards_leg_binding(ctx: dict) -> dict:
    """(5) Binding leg (a)'s user loop at n ranks: ``broadcast_parameters``,
    ``DistributedOptimizer(AdamW, compression=bf16)`` (its hooks fire
    during the backward) and ``broadcast_optimizer_state`` on gpt_small at
    (1ii)'s per-rank batches; the rank's loss, step ms, flash launches,
    responses and fused bytes a step."""
    hvd, core = ctx["hvd"], ctx["core"]
    from horovod_tpu_torch import allgather_object
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss
    batch = ctx["gpt_batch"]
    _, model = _cards_gpt()
    count = _ResponseCount(core)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=CARDS_LR,
                          weight_decay=CARDS_WD),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    count.take()
    steps = sum(CARDS_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()                 # the leg's path starts
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = cross_entropy_loss(model(batch["input"], train=True),
                                  batch["label"])
        loss.backward()
        opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = fa.launch_counts()            # ... and ends
    responses, fused = count.take()
    misplaced = _misplaced(_rank_device(), [
        *model.named_parameters(),
        *((f"optimizer.{k}", t) for st in opt.state.values()
          for k, t in st.items() if k != "step")])
    out = {"losses": losses,
           "mean_losses": [statistics.fmean(x) for x in
                           zip(*allgather_object(losses))],
           "step_ms": step_ms,
           "timed_step_ms_mean": statistics.mean(step_ms[CARDS_STEPS[0]:]),
           "launches_per_step": {k: c / steps for k, c in launches.items()},
           "responses_per_step": responses / steps,
           "fused_bytes_per_step": fused / steps,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "misplaced": misplaced,
           "params_equal_across_ranks": len(set(allgather_object(
               _params_digest(model)))) == 1}
    del model, opt
    _free()
    return out


def _cards_leg_syncbn(ctx: dict) -> dict:
    """(5) ``_SyncBatchNormFn`` at n ranks, each its rows of a global
    batch, against ``F.batch_norm`` on the whole batch in training mode,
    fp32: outputs and input gradients by rows, the weight and bias
    gradients summed over the ranks, the running statistics."""
    import torch.nn.functional as F

    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn
    hvd, rank, n = ctx["hvd"], ctx["rank"], ctx["n"]
    dev = _rank_device()
    shape = CARDS["syncbn_shape"]
    rows, c = shape[0], shape[1]
    g = torch.Generator().manual_seed(5)
    x = (torch.randn((rows * n,) + tuple(shape[1:]), generator=g) * 2
         + 0.5).to(dev)
    w = (torch.rand(c, generator=g) + 0.5).to(dev)
    b = torch.randn(c, generator=g).to(dev)
    dy = torch.randn(x.shape, generator=g).to(dev)
    got, ref = {}, {}
    mine = slice(rank * rows, (rank + 1) * rows)
    for side in ("sync", "plain"):
        xi = (x[mine] if side == "sync" else x).clone().requires_grad_(True)
        wi, bi = (t.clone().requires_grad_(True) for t in (w, b))
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        if side == "sync":
            y = _SyncBatchNormFn.apply(xi, wi, bi, rm, rv, 1e-5, 0.1)
            y.backward(dy[mine])
            got.update(out=y.detach(), dx=xi.grad,
                       dw=hvd.allreduce(wi.grad, op=hvd.Sum, name="bn.dw"),
                       db=hvd.allreduce(bi.grad, op=hvd.Sum, name="bn.db"),
                       running_mean=rm, running_var=rv)
        else:
            y = F.batch_norm(xi, rm, rv, wi, bi, True, 0.1, 1e-5)
            y.backward(dy)
            ref.update(out=y.detach()[mine], dx=xi.grad[mine], dw=wi.grad,
                       db=bi.grad, running_mean=rm, running_var=rv)
    err = {k: (got[k] - ref[k]).abs().max().item() for k in got}
    scale = {k: ref[k].abs().max().item() for k in got}
    return {"shape_per_rank": list(shape), "ranks": n, "dtype": "float32",
            "max_abs_err": err, "max_abs_ref": scale,
            "tolerance": "1e-5 of max|ref|",
            "bad": [k for k in got if err[k] > 1e-5 * max(scale[k], 1.0)]}


CARDS_LEGS = {"one": ("gpt",),
              "cards": ("parity", "gpt", "wires", "resnet", "quiet",
                        "plane", "streams", "binding", "syncbn")}
_CARDS_LEG_FNS = {"parity": _cards_leg_parity, "gpt": _cards_leg_gpt,
                  "wires": _cards_leg_wires, "resnet": _cards_leg_resnet,
                  "quiet": _cards_leg_quiet,
                  "plane": _cards_leg_plane, "streams": _cards_leg_streams,
                  "binding": _cards_leg_binding,
                  "syncbn": _cards_leg_syncbn}


def _rank_device() -> torch.device:
    """This process's card: the current CUDA device."""
    return torch.device("cuda", torch.cuda.current_device())


def cards_worker(mode: str, outdir: str) -> int:
    """``chip_smoke.py --cards-worker one|cards OUTDIR``: one rank of the
    cards phase, started by the port's launcher.  As upstream asks of its
    torch users, the rank makes its own card current
    (``torch.cuda.set_device(hvd.local_rank())``) before it builds
    anything; in a world of more than one rank the NCCL plane must have
    formed.  Its record goes to ``OUTDIR/<mode>_<rank>.json`` after every
    leg.  No card: exit 3."""
    if not torch.cuda.is_available():
        print("cards worker: no CUDA device", file=sys.stderr)
        return 3
    import traceback

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import core
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    rank, n = hvd.rank(), hvd.size()
    st = core.global_state()
    rec = {"rank": rank, "size": n, "local_rank": hvd.local_rank(),
           "device": str(_rank_device()),
           "card": torch.cuda.get_device_name(_rank_device()),
           "device_plane": st.device_plane, "device_index": st.device_index,
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "legs": {}}
    path = os.path.join(outdir, f"{mode}_{rank}.json")

    def save():
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
    ctx = {"hvd": hvd, "core": core, "rank": rank, "n": n,
           "outdir": outdir}
    try:
        if n > 1 and not (st.device_plane
                          and rec["backend"] == CARDS_BACKEND):
            raise RuntimeError(f"rank {rank}: no {CARDS_BACKEND} device "
                               f"plane formed ({rec})")
        for name in CARDS_LEGS[mode]:
            t0 = time.perf_counter()
            rec["legs"][name] = _CARDS_LEG_FNS[name](ctx)
            rec["legs"][name]["leg_s"] = time.perf_counter() - t0
            save()
    except BaseException:
        rec["error"] = traceback.format_exc()[-4000:]
        save()
        raise
    finally:
        hvd.shutdown()
    return 0


def _cards_world(n: int, mode: str, outdir: str) -> dict:
    """``horovodrun-tpu-torch -np n`` (the port's launcher as a module) of
    ``--cards-worker mode``, with NCCL's INFO log at n > 1 for its
    transports and the link types of its graph search; the ranks'
    records, the exit code, those counts and the output's tail."""
    import re
    from collections import Counter
    argv = ["-np", str(n), "-H", f"localhost:{n}", sys.executable,
            os.path.abspath(__file__), "--cards-worker", mode, outdir]
    env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,GRAPH"} \
        if n > 1 else {}
    t0 = time.perf_counter()
    rc, text = _launcher_run(argv, env, timeout=CARDS_WORLD_TIMEOUT)
    recs = []
    for r in range(n):
        p = os.path.join(outdir, f"{mode}_{r}.json")
        if os.path.exists(p):
            with open(p) as f:
                recs.append(json.load(f))
        else:
            recs.append({"rank": r, "legs": {}})
    transports = Counter(m.group(1) for m in
                         re.finditer(r"via (\S+)", text))
    # NCCL's graph search names the links it found ("type NVL/PIX").
    links = Counter(m.group(1) for m in
                    re.finditer(r"Pattern.*type (\S+?),", text))
    return {"rc": rc, "wall_s": time.perf_counter() - t0, "ranks": recs,
            "transports": dict(transports), "link_types": dict(links),
            "nccl_version": next(iter(re.findall(r"NCCL version (\S+)",
                                                 text)), None),
            "tail": "\n".join(line for line in text.splitlines()
                              if "NCCL INFO" not in line)[-3000:]}


def _smi(*args: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _cards_reference(n: int, problems: list[str], train) -> dict:
    """The one-card legs the world is held against, on card 0 over a
    one-rank NCCL group: gpt_small at B (the parity leg's first steps and
    the per-card baseline); with n > 1 also the wires, ResNet-50 in bf16
    at B=128 and fp32 ResNet-50 at B=128 with plain BatchNorm, once more
    on images moved by one ulp (the parameters' own sensitivity)."""
    from horovod_tpu_torch import synthetic_image_batch
    ref: dict = {}
    with _one_rank_nccl():
        batch = _text_batch(CARDS["batch"], seed=0)
        _, model = _cards_gpt()
        ref["gpt"] = cards_train(model, {"compression": "bf16"}, batch,
                                 sum(CARDS_STEPS), warmup=CARDS_STEPS[0],
                                 probe=True, profile=KERNEL_CATEGORIES)
        ref["gpt"]["batch_digest"] = _batch_digest(batch)
        del model
        _free()
        if train is not None:
            ref["gpt"]["losses_bitwise_train_phase"] = \
                ref["gpt"]["losses"] == train["losses"]
            if not ref["gpt"]["losses_bitwise_train_phase"]:
                problems.append("cards: the one-card reference's losses are "
                                "not the train phase's")
        if n > 1:
            ref["wires"] = {}
            for name, kw in CARDS_WIRES:
                _, model = _cards_gpt()
                ref["wires"][name] = cards_train(
                    model, kw, batch, sum(CARDS_WIRE_STEPS),
                    warmup=CARDS_WIRE_STEPS[0], probe=True)
                del model
                _free()
            b, size = CARDS["cnn_batch"], CARDS["image"]
            classes = CARDS["resnet"]["num_classes"]
            model = _cards_resnet(torch.bfloat16)
            images = synthetic_image_batch(b, size, classes, seed=0)
            torch.backends.cudnn.benchmark = True
            try:
                ref["resnet_bf16"] = cards_train(
                    model, {"compression": "bf16"}, images, sum(CARDS_STEPS),
                    warmup=CARDS_STEPS[0], optimizer="sgd",
                    profile=CNN_CATEGORIES)
            finally:
                torch.backends.cudnn.benchmark = False
            del model, images
            _free()
            full = synthetic_image_batch(b, size, classes, seed=3)
            ref["bn_batch_digest"] = _batch_digest(full)
            ref["bn_plain"] = bn_steps(_cards_resnet(torch.float32), full,
                                       CARDS_BN_STEPS)
            moved = {"image": full["image"] * (1 + 2.0 ** -23),
                     "label": full["label"]}
            ref["bn_moved"] = bn_steps(_cards_resnet(torch.float32), moved,
                                       CARDS_BN_STEPS)
            del full, moved
            _free()
    return ref


def _short_profile(prof: dict | None) -> dict | None:
    """A profile's totals and categories, without its kernel list."""
    if prof is None:
        return None
    return {k: v for k, v in prof.items() if k != "top"}


def _loss_diffs(got: list, want: list) -> list[float]:
    return [abs(x - y) for x, y in zip(got, want)]


def _ss_two_donors(problems: list[str]) -> dict:
    """The training grow 2 -> 3 on three cards: two incumbents (cards 0
    and 1, already on the NCCL plane) share the joiner's bulk round, each
    streaming its range of the image; the grown world takes
    SS_GROWN_STEPS steps on the plane and stops."""
    from horovod_tpu_torch import gpt_small
    layers = gpt_small().num_layers
    with tempfile.TemporaryDirectory(prefix="sstrain2") as outdir:
        r0, r1, joi = _ss_world([("train2", 0, 2, 0), ("train2", 1, 2, 1),
                                 ("train2-joiner", 0, 0, 2)], outdir)
    join = joi.get("join", {})
    grown = [s for r in (r0, r1, joi) for s in r["steps"]
             if s["size"] == 3]
    first = next((s for s in joi["steps"] if s["size"] == 3), None)
    donors = join.get("donor_stats") or {}
    line = {"phase": "cards", "leg": "e-train-grow-two-donors",
            "model": "gpt_small", "batch": 8, "seq": 2048,
            "dtype": "bfloat16", "ranks": "2->3",
            "card": "cards 0, 1 and the joiner's 2, one a process",
            "catch_up_ms": join.get("catch_up_ms"),
            "bulk_bytes": join.get("bulk_bytes"),
            "bulk_gb_per_s": join.get("bulk_gb_per_s"),
            "donor_stats": donors,
            "grow": {"incumbents": [r0.get("grow"), r1.get("grow")]},
            "step_ms_before": [s["ms"] for s in r0["steps"]
                               if s["size"] == 2],
            "grown_step_ms": {"rank0": [s["ms"] for s in r0["steps"]
                                        if s["size"] == 3],
                              "joiner": [s["ms"] for s in joi["steps"]
                                         if s["size"] == 3]},
            "grown_plane": sorted({s["plane"] for s in grown}),
            "grown_device_plane": [s.get("device_plane") for s in grown],
            "devices": sorted({s.get("device") for r in (r0, r1, joi)
                               for s in r["steps"]}),
            "join_wall_s": None if first is None
            else first["t_end"] - joi["t_announce"],
            "digests": [(d["name"], d["equal"]) for d in r0["digests"]],
            "joined_digest_equals_stamp":
                joi.get("joined_digest_equals_stamp"),
            "flight": {"rank0": r0["flight"], "rank1": r1["flight"],
                       "joiner": joi["flight"]}}
    emit(line)
    tag = "cards statesync (e)"
    if [g and g.get("size") for g in line["grow"]["incumbents"]] != [3, 3]:
        problems.append(f"{tag}: no grow to 3: {line['grow']}")
    if len(donors) != 2 or not all(b for b, _ in donors.values()):
        problems.append(f"{tag}: the bulk round's donors {donors}")
    if not line["joined_digest_equals_stamp"]:
        problems.append(f"{tag}: the joiner's image is not the stamp's")
    digests = r0["digests"] + r1["digests"] + joi["digests"]
    if len(r0["digests"]) != SS_GROWN_STEPS + 1 \
            or not all(d["equal"] for d in digests):
        problems.append(f"{tag}: digests {line['digests']}")
    if line["grown_plane"] != ["card"] or not all(
            line["grown_device_plane"]) or len(grown) != 3 * SS_GROWN_STEPS \
            or line["devices"] != ["cuda:0", "cuda:1", "cuda:2"]:
        problems.append(f"{tag}: grown steps {len(grown)} on "
                        f"{line['grown_plane']} {line['devices']}")
    if not all(_ss_launches_ok(r["steps"], layers) for r in (r0, r1, joi)):
        problems.append(f"{tag}: flash launches not {layers} of each "
                        f"kernel on every step")
    if not all(math.isfinite(s["loss"]) for r in (r0, r1, joi)
               for s in r["steps"]):
        problems.append(f"{tag}: a loss is not finite")
    return line


def _cards_statesync(n: int, problems: list[str]) -> dict:
    """(6) The statesync phase's legs with each process on a card of its
    own: (a)/(b) the training grow 1 -> 2 (the grown world on the NCCL
    plane) and the preemption 2 -> 1, (d) disaggregated prefill across two
    cards, (c) the serving grow 2 -> 3 on three cards, and (e) the
    training grow 2 -> 3 with two donors."""
    t0 = time.perf_counter()
    train = _ss_training(problems, cards=True)
    disagg = _ss_disagg(problems, cards=True)
    out = {"grown_step_ms": train["a"]["grown_step_ms"],
           "grown_plane": train["a"]["grown_plane"],
           "catch_up_ms": train["a"]["catch_up_ms"],
           "ttft_ms_p50": disagg["ttft_ms"]["p50"],
           "colocated_ttft_ms_p50": disagg["colocated"]["ttft_ms"]["p50"]}
    if n >= 3:
        serve = _ss_serving(problems, cards=True)
        out["serve_catch_up_ms"] = serve["catch_up_ms"]
        two = _ss_two_donors(problems)
        out["two_donors_catch_up_ms"] = two["catch_up_ms"]
    else:
        for leg in ("c-serve-grow", "e-train-grow-two-donors"):
            emit({"phase": "cards", "leg": leg,
                  "not_run": f"the machine shows {n} cards"})
    out["seconds"] = time.perf_counter() - t0
    return out


def _flash_per_step() -> float:
    """Launches of each flash kernel a gpt step: one a layer on the card,
    none where the wrappers run their plain versions (the CPU)."""
    return float(_cards_gpt()[0].num_layers) \
        if _rank_device().type == "cuda" else 0.0


def _cards_check_gpt(ref: dict, recs: list, n: int, tag: str,
                     problems: list[str]) -> dict:
    """(1) the parity and throughput legs of every rank."""
    per_step = _flash_per_step()
    out = {}
    for name in ("parity", "gpt"):
        legs = [r["legs"].get(name) for r in recs]
        if any(leg is None for leg in legs):
            problems.append(f"{tag} {name}: a rank has no record")
            return out
        for r, leg in enumerate(legs):
            if leg["misplaced"]:
                problems.append(f"{tag} {name}: rank {r}'s "
                                f"{leg['misplaced'][:4]} lie off "
                                f"{leg['device']}")
            if set(leg["launches_per_step"].values()) != {per_step} \
                    or len(leg["launches_per_step"]) != 3:
                problems.append(f"{tag} {name}: rank {r} launched "
                                f"{leg['launches_per_step']} a step")
            if leg["losses"] != legs[0]["losses"]:
                problems.append(f"{tag} {name}: the ranks' losses differ")
            if not all(math.isfinite(x) for x in leg["losses"]):
                problems.append(f"{tag} {name}: a loss is not finite")
    one = ref["gpt"]
    par = [r["legs"]["parity"] for r in recs]
    diffs = _loss_diffs(par[0]["losses"], one["losses"])
    out["parity"] = {
        "rows_per_rank": par[0]["rows"], "steps": CARDS_PARITY_STEPS,
        "losses": par[0]["losses"],
        "one_card_losses": one["losses"][:CARDS_PARITY_STEPS],
        "loss_abs_diff": diffs,
        "tolerance": {"first": CARDS_FIRST_LOSS_TOL,
                      "later": CARDS_LOSS_TOL},
        "params_equal_every_step": [p["params_equal_every_step"]
                                    for p in par],
        "digests_step_last": par[0]["digests"][-1][:1],
        "batch_equal_one_card": par[0]["batch_digest"]
        == one["batch_digest"]}
    if diffs[0] > CARDS_FIRST_LOSS_TOL or max(diffs) > CARDS_LOSS_TOL:
        problems.append(f"{tag} parity: losses {diffs} from one card's")
    if not all(p["params_equal_every_step"] for p in par):
        problems.append(f"{tag} parity: parameters differ across "
                        f"ranks: {[p['digests'] for p in par][:1]}")
    if not out["parity"]["batch_equal_one_card"]:
        problems.append(f"{tag} parity: the global batch is not the "
                        f"one-card leg's")
    gpt = [r["legs"]["gpt"] for r in recs]
    tokens = CARDS["batch"] * CARDS["seq"]
    mean_ms = statistics.fmean(g["timed_step_ms_mean"] for g in gpt)
    out["gpt"] = {
        "rows_per_rank": CARDS["batch"], "seq": CARDS["seq"],
        "step_ms": [g["timed_step_ms_mean"] for g in gpt],
        "step_ms_all": gpt[0]["step_ms"],
        "tokens_per_s_per_card": tokens / (mean_ms / 1e3),
        "one_card_step_ms": one["timed_step_ms_mean"],
        "one_card_tokens_per_s": tokens / (one["timed_step_ms_mean"] / 1e3),
        "scaling_per_card": one["timed_step_ms_mean"] / mean_ms,
        "scaling_total": n * one["timed_step_ms_mean"] / mean_ms,
        "sync_ms": [g.get("sync_ms") for g in gpt],
        "one_card_sync_ms": one.get("sync_ms"),
        "profile_rank0": _short_profile(gpt[0].get("profile")),
        "one_card_profile": _short_profile(one.get("profile")),
        "wire_bytes_per_rank": gpt[0]["wire_bytes"],
        "peak_memory_bytes": [g.get("peak_memory_bytes") for g in gpt],
        "launches_per_step": gpt[0]["launches_per_step"],
        "launches": gpt[0]["launches"], "losses": gpt[0]["losses"]}
    return out


def _cards_check_wires(ref: dict, recs: list, n: int, problems: list[str]
                       ) -> dict:
    """(2) each wire against the bf16 leg at n cards, its one-card spread
    beside."""
    out = {}
    bf16 = recs[0]["legs"]["gpt"]
    steps = sum(CARDS_WIRE_STEPS)
    one_bf16 = ref["gpt"]["losses"][:steps]
    for name, _ in CARDS_WIRES:
        legs = [r["legs"]["wires"][name] for r in recs]
        one = ref["wires"][name]
        diff = max(_loss_diffs(legs[0]["losses"], bf16["losses"][:steps]))
        spread = max(_loss_diffs(one["losses"], one_bf16))
        out[name] = {
            "losses": legs[0]["losses"],
            "loss_max_abs_diff_bf16": diff,
            "one_card_loss_max_abs_diff_bf16": spread,
            "within_one_card_spread": diff <= spread,
            "sync_ms": [x.get("sync_ms") for x in legs],
            "one_card_sync_ms": one.get("sync_ms"),
            "wire_bytes_per_rank": legs[0]["wire_bytes"],
            "wire_share_of_bf16": legs[0]["wire_bytes"] / bf16["wire_bytes"],
            "optimizer_state_bytes_per_rank": [x["optimizer_state_bytes"]
                                               for x in legs],
            "optimizer_state_share_of_one_card":
                legs[0]["optimizer_state_bytes"]
                / ref["gpt"]["optimizer_state_bytes"],
            "step_ms": [x["timed_step_ms_mean"] for x in legs],
            "peak_memory_bytes": [x.get("peak_memory_bytes") for x in legs],
            "launches_per_step": legs[0]["launches_per_step"]}
        if any(x["losses"] != legs[0]["losses"] for x in legs):
            problems.append(f"cards wires {name}: the ranks' losses differ")
        bound = max(CARDS_LOSS_TOL, spread)
        out[name]["tolerance"] = bound
        if not diff <= bound:
            problems.append(f"cards wires {name}: losses {diff} from the "
                            f"bf16 leg's, over {bound}")
        for r, x in enumerate(legs):
            if x["misplaced"]:
                problems.append(f"cards wires {name}: rank {r}'s "
                                f"{x['misplaced'][:4]} off its card")
    return out


def _cards_check_resnet(ref: dict, recs: list, n: int, outdir: str,
                        problems: list[str]) -> dict:
    """(3) ResNet-50's scaling, and cross-replica BatchNorm at n cards
    against one card with plain BatchNorm, held as the fit phase's (e)."""
    legs = [r["legs"]["resnet"] for r in recs]
    one = ref["resnet_bf16"]
    b = CARDS["cnn_batch"]
    mean_ms = statistics.fmean(x["bf16"]["timed_step_ms_mean"] for x in legs)
    out = {"bf16": {
        "batch_per_card": b, "image_size": CARDS["image"],
        "step_ms": [x["bf16"]["timed_step_ms_mean"] for x in legs],
        "images_per_s_per_card": b / (mean_ms / 1e3),
        "one_card_step_ms": one["timed_step_ms_mean"],
        "scaling_per_card": one["timed_step_ms_mean"] / mean_ms,
        "step_ms_all": legs[0]["bf16"]["step_ms"],
        "one_card_step_ms_all": one["step_ms"],
        "profile_rank0": _short_profile(legs[0]["bf16"].get("profile")),
        "one_card_profile": _short_profile(one.get("profile")),
        "losses": legs[0]["bf16"]["losses"],
        "peak_memory_bytes": [x["bf16"].get("peak_memory_bytes")
                              for x in legs]}}
    for r, x in enumerate(legs):
        if x["bf16"]["misplaced"]:
            problems.append(f"cards resnet: rank {r}'s "
                            f"{x['bf16']['misplaced'][:4]} off its card")
    plain, moved = ref["bn_plain"], ref["bn_moved"]
    logits = torch.cat([torch.load(os.path.join(outdir,
                                                f"bn_logits_{r}.pt"))
                        for r in range(n)])
    state = torch.load(os.path.join(outdir, "bn_state.pt"))
    cross = legs[0]["cross_bn"]
    e = {"batch": b, "rows_per_rank": cross["rows"], "dtype": "float32",
         "steps": CARDS_BN_STEPS,
         "logits_rel_err": _rel_err(logits, plain["logits"]),
         "loss_rel_err": max(abs(x - y) / abs(y) for x, y in
                             zip(cross["losses"], plain["losses"])),
         "stats_max_abs_err": _max_err(state["stats"], plain["stats"]),
         "params_max_abs_err": [_max_err(c, p) for c, p in
                                zip(state["params"], plain["params"])],
         "params_one_ulp_sensitivity": [_max_err(m, p) for m, p in
                                        zip(moved["params"],
                                            plain["params"])],
         "losses": cross["losses"], "one_card_losses": plain["losses"],
         "step_ms": [x["cross_bn"]["step_ms"] for x in legs],
         "one_card_step_ms": plain["step_ms"],
         "params_equal_across_ranks": [x["cross_bn"]
                                       ["params_equal_across_ranks"]
                                       for x in legs],
         "batch_equal_one_card": cross["batch_digest"]
         == ref["bn_batch_digest"]}
    out["cross_bn"] = e
    bounds = {"logits_rel_err": CNN_LOGITS_REL,
              "loss_rel_err": CNN_LOGITS_REL,
              "stats_max_abs_err": CNN_STATS_TOL}
    problems += [f"cards cross-replica BN: {k} {e[k]} over {bound}"
                 for k, bound in bounds.items() if not e[k] <= bound]
    for step, (err, floor) in enumerate(zip(
            e["params_max_abs_err"], e["params_one_ulp_sensitivity"])):
        if not err <= max(CNN_PARAMS_TOL, floor):
            problems.append(f"cards cross-replica BN: parameters after step "
                            f"{step + 1} {err} apart, over {CNN_PARAMS_TOL} "
                            f"and the one-ulp sensitivity {floor}")
    if not all(e["params_equal_across_ranks"]) \
            or not e["batch_equal_one_card"]:
        problems.append(f"cards cross-replica BN: ranks' parameters equal "
                        f"{e['params_equal_across_ranks']}, batch equal "
                        f"{e['batch_equal_one_card']}")
    return out


def _cards_check_quiet(ref: dict, recs: list, problems: list[str]) -> dict:
    """The quiet leg beside the default cycle's: the gpt and ResNet-50
    steps, their profiles' idle share; its gpt losses must be (1ii)'s
    (the same batch, weights and wire)."""
    out = {"cycle_time_ms": recs[0]["legs"]["quiet"]["cycle_time_ms"],
           "threads_rank0": recs[0]["legs"]["quiet"]["threads"]}
    for name, default, one in (
            ("gpt", lambda r: r["legs"]["gpt"], ref["gpt"]),
            ("resnet_bf16", lambda r: r["legs"]["resnet"]["bf16"],
             ref.get("resnet_bf16"))):
        legs = [r["legs"]["quiet"][name] for r in recs]
        prof = legs[0].get("profile") or {}
        out[name] = {
            "step_ms": [x["timed_step_ms_mean"] for x in legs],
            "default_cycle_step_ms": [default(r)["timed_step_ms_mean"]
                                      for r in recs],
            "one_card_step_ms": one["timed_step_ms_mean"] if one else None,
            "device_idle_share": prof.get("device_idle_share"),
            "kernel_ms": prof.get("kernel_ms")}
        for r, x in enumerate(legs):
            if x["misplaced"]:
                problems.append(f"cards quiet {name}: rank {r}'s "
                                f"{x['misplaced'][:4]} off its card")
    gpt = recs[0]["legs"]["gpt"]["losses"]
    quiet = recs[0]["legs"]["quiet"]["gpt"]["losses"]
    out["gpt"]["losses_equal_default_cycle"] = quiet == gpt
    if max(_loss_diffs(quiet, gpt)) > CARDS_LOSS_TOL:
        problems.append(f"cards quiet: gpt losses {quiet} against {gpt}")
    return out


def _cards_check_eager(ref: dict, recs: list, n: int, problems: list[str]
                       ) -> dict:
    """(4) and (5): the plane, the streams, the binding and
    SyncBatchNorm at n ranks."""
    out = {"plane": recs[0]["legs"]["plane"],
           "streams": {k: v for k, v in recs[0]["legs"]["streams"].items()
                       if k.startswith("streams")}}
    for r, rec in enumerate(recs):
        legs = rec["legs"]
        if legs["plane"]["mismatches"]:
            problems.append(f"cards plane: rank {r} disagrees with the host "
                            f"in {legs['plane']['mismatches']}")
        if legs["plane"]["on_card"] and legs["plane"]["native_calls_during"]:
            problems.append(f"cards plane: rank {r} ran native host kernels "
                            f"{legs['plane']['native_calls_during']}")
        problems += [f"cards streams rank {r}: {p}"
                     for p in legs["streams"]["problems"]]
        for k, v in legs["streams"].items():
            # On the cards every response of a burst is a device response.
            if k.startswith("streams") and (
                    not v["device_plane"] or v["on_card"] and
                    sum(v["device_responses_by_stream"])
                    != sum(v["responses_by_stream"])):
                problems.append(f"cards streams rank {r} {k}: {v}")
        if legs["syncbn"]["bad"]:
            problems.append(f"cards SyncBatchNorm rank {r}: "
                            f"{legs['syncbn']['bad']} off "
                            f"{legs['syncbn']['max_abs_err']}")
    binding = [r["legs"]["binding"] for r in recs]
    trainer = recs[0]["legs"]["gpt"]
    diffs = _loss_diffs(binding[0]["mean_losses"], trainer["losses"])
    per_step = _flash_per_step()
    out["binding"] = {
        "mean_losses": binding[0]["mean_losses"],
        "trainer_losses": trainer["losses"], "loss_abs_diff": diffs,
        "step_ms": [x["timed_step_ms_mean"] for x in binding],
        "trainer_step_ms": [r["legs"]["gpt"]["timed_step_ms_mean"]
                            for r in recs],
        "responses_per_step": binding[0]["responses_per_step"],
        "fused_bytes_per_step": binding[0]["fused_bytes_per_step"],
        "launches_per_step": binding[0]["launches_per_step"],
        "peak_memory_bytes": [x["peak_memory_bytes"] for x in binding]}
    out["syncbn"] = recs[0]["legs"]["syncbn"]
    if diffs[0] > CARDS_FIRST_LOSS_TOL or max(diffs) > CARDS_LOSS_TOL:
        problems.append(f"cards binding: losses {diffs} from Trainer.step's")
    for r, x in enumerate(binding):
        if x["misplaced"] or not x["params_equal_across_ranks"]:
            problems.append(f"cards binding rank {r}: misplaced "
                            f"{x['misplaced'][:4]}, parameters equal "
                            f"{x['params_equal_across_ranks']}")
        if set(x["launches_per_step"].values()) != {per_step}:
            problems.append(f"cards binding rank {r}: launches "
                            f"{x['launches_per_step']}")
    return out


def phase_cards(train: dict | None = None) -> dict:
    """The data-parallel main path across the cards of this host (see the
    module docstring)."""
    t_phase = time.perf_counter()
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    problems: list[str] = []
    n = torch.cuda.device_count()
    cards = {"phase": "cards", "leg": "cards", "count": n,
             "nvidia_smi": _smi("--query-gpu=name,power.limit",
                                "--format=csv,noheader").splitlines()}
    if n > 1:
        cards["topology"] = _smi("topo", "-m").splitlines()
        cards["nvlink"] = _smi("nvlink", "--status").splitlines()[:12]
    emit(cards)
    torch.cuda.empty_cache()
    ref = _cards_reference(n, problems, train)
    emit({"phase": "cards", "leg": "one-card-reference", "card":
          cards["nvidia_smi"][:1],
          **{k: {kk: vv for kk, vv in v.items()
                 if kk not in ("digests", "launches", "profile")}
             for k, v in ref.items() if k in ("gpt", "resnet_bf16")},
          "wires": {k: {"losses": v["losses"], "sync_ms": v.get("sync_ms"),
                        "wire_bytes": v["wire_bytes"],
                        "optimizer_state_bytes": v["optimizer_state_bytes"]}
                    for k, v in ref.get("wires", {}).items()},
          "bn_plain": {k: ref["bn_plain"][k] for k in ("losses", "step_ms")}
          if "bn_plain" in ref else None})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cards") as outdir:
        world = _cards_world(1, "one", outdir)
    one = world["ranks"][0]
    leg = one["legs"].get("gpt")
    line = {"phase": "cards", "leg": "launcher-np1", "rc": world["rc"],
            "wall_s": world["wall_s"], "device_plane": one.get(
                "device_plane"), "device": one.get("device")}
    if world["rc"] != 0 or leg is None:
        problems.append(f"cards -np 1: rc {world['rc']}: "
                        f"{one.get('error') or world['tail'][-1500:]}")
    else:
        diffs = _loss_diffs(leg["losses"], ref["gpt"]["losses"])
        line.update(losses=leg["losses"], loss_abs_diff_one_card=diffs,
                    losses_bitwise_one_card=leg["losses"]
                    == ref["gpt"]["losses"],
                    step_ms=leg["timed_step_ms_mean"],
                    one_card_step_ms=ref["gpt"]["timed_step_ms_mean"],
                    launches_per_step=leg["launches_per_step"],
                    peak_memory_bytes=leg.get("peak_memory_bytes"))
        if max(diffs) > CARDS_LOSS_TOL or diffs[0] > CARDS_FIRST_LOSS_TOL:
            problems.append(f"cards -np 1: losses {diffs} from one card's")
        if leg["misplaced"]:
            problems.append(f"cards -np 1: {leg['misplaced'][:4]} off the "
                            f"card")
    emit(line)
    launches = leg["launches"] if leg else {}
    summary: dict = {}
    if n < 2:
        for name in ("gpt-dp", "wires", "resnet50", "device-plane",
                     "binding", "two-card-reduce", "statesync"):
            emit({"phase": "cards", "leg": name,
                  "not_run": f"the machine shows {n} card"})
    else:
        summary = _cards_n(ref, n, problems)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "cards", "leg": "summary", "seconds": seconds,
          "cards": n, "card": cards["nvidia_smi"], **summary,
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": launches}


def _cards_n(ref: dict, n: int, problems: list[str]) -> dict:
    """The n-card legs: the launcher's world of n ranks (legs 1-5), the
    two-card reduce, and statesync's legs with each rank on a card."""
    with tempfile.TemporaryDirectory(prefix="cards") as outdir:
        world = _cards_world(n, "cards", outdir)
        recs = world["ranks"]
        emit({"phase": "cards", "leg": "world", "ranks": n,
              "rc": world["rc"], "wall_s": world["wall_s"],
              "nccl_version": world["nccl_version"],
              "nccl_transports": world["transports"],
              "nccl_link_types": world["link_types"],
              "device_plane": [r.get("device_plane") for r in recs],
              "backend": [r.get("backend") for r in recs],
              "devices": [r.get("device") for r in recs],
              "leg_s": {k: v.get("leg_s") for k, v in
                        recs[0]["legs"].items()}})
        if world["rc"] != 0:
            problems.append("cards world: rc {}: {}".format(
                world["rc"], " | ".join(
                    r.get("error", "")[-1200:] for r in recs
                    if r.get("error")) or world["tail"][-2000:]))
        on_card = _rank_device().type == "cuda"
        for r, rec in enumerate(recs):
            if rec.get("device") != (f"cuda:{r}" if on_card else "cpu") \
                    or not rec.get("device_plane"):
                problems.append(f"cards world: rank {r} on "
                                f"{rec.get('device')}, plane "
                                f"{rec.get('device_plane')}")
        done = set.intersection(*(set(r["legs"]) for r in recs))
        out = {"transports": world["transports"]}
        if {"parity", "gpt"} <= done:
            g = _cards_check_gpt(ref, recs, n, "cards", problems)
            for name, leg in g.items():
                emit({"phase": "cards", "leg": f"gpt-{name}", "ranks": n,
                      **leg})
            out["gpt_step_ms"] = g["gpt"]["step_ms"]
            out["gpt_scaling_per_card"] = g["gpt"]["scaling_per_card"]
        if "wires" in done:
            w = _cards_check_wires(ref, recs, n, problems)
            emit({"phase": "cards", "leg": "wires", "ranks": n, **w})
            out["wire_sync_ms"] = {k: v["sync_ms"] for k, v in w.items()}
        if "resnet" in done:
            c = _cards_check_resnet(ref, recs, n, outdir, problems)
            emit({"phase": "cards", "leg": "resnet50", "ranks": n, **c})
            out["resnet_scaling_per_card"] = c["bf16"]["scaling_per_card"]
        if "quiet" in done:
            q = _cards_check_quiet(ref, recs, problems)
            emit({"phase": "cards", "leg": "quiet-core", "ranks": n, **q})
            out["quiet_step_ms"] = {k: v["step_ms"] for k, v in q.items()
                                    if isinstance(v, dict)}
        if {"plane", "streams", "binding", "syncbn"} <= done:
            e = _cards_check_eager(ref, recs, n, problems)
            for name, leg in e.items():
                emit({"phase": "cards", "leg": name, "ranks": n, **leg})
            out["plane_busbw_gb_per_s"] = \
                e["plane"]["fused_allreduce"]["busbw_gb_per_s"]
    across = _reduce_two_cards(problems)
    emit({"phase": "cards", "leg": "two-card-reduce", **across})
    if CARDS["statesync"]:
        out["statesync"] = _cards_statesync(n, problems)
    return out


# ---------------------------------------------------------------------------
# The shard phase: sharded parameters (tensor parallelism, fsdp-sharded
# leaves, experts held over ep, sharded checkpoints), on one card and on
# four, one process a card under the port's launcher
# ---------------------------------------------------------------------------
# gpt_small as the train phase trains it, the parallel phase's MoE, and
# ResNet-50 at the reference benchmark's batch (a global batch of
# cnn_batch, half a dp rank).  The CPU rehearsal of the phase
# (tests/torch_shard_rehearsal.py) puts small sizes here.
SHARD = dict(gpt="gpt_small", batch=8, seq=2048, moe=dict(PARALLEL_MOE),
             resnet=dict(stage_sizes=(3, 4, 6, 3), num_filters=64,
                         num_classes=1000),
             image=224, cnn_batch=128)
SHARD_CARDS = 4
SHARD_STEPS = (WARMUP_STEPS, TIMED_STEPS)   # the tp=4 leg
SHARD_CHECK_STEPS = 3                       # the bitwise legs, each run
SHARD_WORLD_TIMEOUT = 600.0
# The reference's canonical tensor-parallel table (flax paths and dims),
# every kernel and the embedding sharded on dim 0 over fsdp, the experts
# over ep, and test_trainer_tp_sharded_head's table.
SHARD_TP = ((r"attn/w[qkv]/kernel", (None, "tp", None)),
            (r"attn/wo/kernel", ("tp", None, None)),
            (r"mlp/(gate|up)/kernel", (None, "tp")),
            (r"mlp/down/kernel", ("tp", None)))
SHARD_FSDP = ((r"embedding|kernel", ("fsdp",)),)
SHARD_EXPERTS = ((r"moe/w[io]$", ("ep",)),)
SHARD_HEAD = ((r"head/kernel", (None, "tp")), (r"head/bias", ("tp",)))
# gpt_small's parameters and AdamW state a rank (4 + 8 bytes a
# parameter): at tp=4 the table keeps 105,597,696 of 190,532,352
# parameters a rank, at fsdp=4 every leaf of two dims or more is a
# quarter.
SHARD_RECKONED = {"tp": 1_267_172_352, "fsdp": 571_769_856}


def _shard_rules(table):
    from horovod_tpu_torch.parallel.sharding import ShardingRules
    return ShardingRules(list(table))


def _reckoned_bytes(model, mesh, table, moments: int = 2) -> int:
    """This rank's bytes of parameters and optimizer moments as the rule
    table cuts the model's flax leaves (4 bytes an element each)."""
    from horovod_tpu_torch.parallel.sharding import plan_sharding
    total = 0
    for leaf in plan_sharding(model, mesh, _shard_rules(table)).values():
        parts = math.prod(p for _, _, p in leaf.splits)
        total += math.prod(leaf.flax_shape) // parts
    return total * 4 * (1 + moments)


def _state_bytes(state) -> int:
    """The bytes this rank holds of parameters and optimizer tensors
    (step counters aside)."""
    params = sum(p.numel() * p.element_size()
                 for p in state.model.parameters())
    return params + sum(t.numel() * t.element_size()
                        for st in state.optimizer.state.values()
                        for k, t in st.items()
                        if torch.is_tensor(t) and t.dim() > 0)


def _whole_digest(state) -> str:
    """SHA-256 of the whole parameters and buffers of a state, sharded
    ones gathered from every rank (every rank calls it alike)."""
    import hashlib
    sharding = state.sharding
    tensors = {}
    for name, p in state.model.named_parameters():
        t = p.detach()
        if sharding is not None and name in sharding.leaves:
            t = sharding.gather(name, t)
        tensors[name] = t
    tensors.update((n, b) for n, b in state.model.named_buffers())
    digest = hashlib.sha256()
    for name, t in sorted(tensors.items()):
        digest.update(name.encode())
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return digest.hexdigest()


def shard_train(model, mesh, steps: int, batch: dict, *, table=None,
                sync_kw: dict | None = None, batch_spec=None,
                optimizer: str = "adamw", warmup: int = 0,
                profile: bool = False, keep: bool = False) -> dict:
    """``Trainer.step`` on ``mesh`` with ``param_rules`` from ``table``
    (None: no rules), AdamW(3e-4, wd 1e-4) or SGD(0.1, 0.9) and
    ``GradSyncConfig(op="average", compression="bf16", **sync_kw)``:
    losses, step ms, the flash launches of the steps, peak memory, the
    bytes of parameters and optimizer state this rank holds, the whole
    state's digest, and (``profile``) one more step under the profiler.
    ``keep``: the trainer and state come back too."""
    from horovod_tpu_torch import GradSyncConfig, Trainer
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import data_axes
    device = next(model.parameters()).device
    if optimizer == "adamw":
        opt = torch.optim.AdamW(model.parameters(), lr=CARDS_LR,
                                weight_decay=CARDS_WD)
    else:
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sync = GradSyncConfig(**{"op": "average", "compression": "bf16",
                             "axes": data_axes(mesh) or ("dp",),
                             **(sync_kw or {})})
    trainer = Trainer(model, opt, mesh, sync=sync, batch_spec=batch_spec,
                      param_rules=None if table is None
                      else _shard_rules(table))
    state = trainer.init()
    _card_sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launch_counts()                 # the leg's path starts
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        _card_sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = fa.launch_counts()            # ... and ends
    out = {"losses": losses, "step_ms": step_ms,
           "timed_step_ms_mean": statistics.mean(step_ms[warmup:]),
           "launches_per_step": {k: c / steps for k, c in launches.items()},
           "state_bytes": _state_bytes(state),
           "sharded_leaves": 0 if state.sharding is None
           else len(state.sharding.leaves),
           "split_layers": sum(getattr(m, "split", None) is not None
                               for m in model.modules()),
           "misplaced": _misplaced(device, [
               *model.named_parameters(),
               *((f"optimizer.{k}", t)
                 for st in state.optimizer.state.values()
                 for k, t in st.items() if k != "step")])}
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        if profile:
            out["profile"] = _short_profile(_profile(
                lambda: trainer.step(state, batch),
                out["timed_step_ms_mean"]))
    out["step"] = state.step
    out["digest"] = _whole_digest(state)
    if keep:
        out["trainer"], out["state"] = trainer, state
    else:
        del trainer, state, opt
    return out


def _shard_gpt(mesh=None, **overrides):
    import horovod_tpu_torch as hvt
    cfg = getattr(hvt, SHARD["gpt"])(**{"attention": "flash",
                                        "max_seq_len": SHARD["seq"],
                                        "mesh": mesh, **overrides})
    return hvt.TransformerLM(cfg, seed=0)


def _shard_text(rows: int, seq: int, seed: int) -> dict:
    import horovod_tpu_torch as hvt
    vocab = getattr(hvt, SHARD["gpt"])().vocab_size
    return hvt.synthetic_text_batch(rows, seq, vocab, seed=seed)


def _shard_one_card(problems: list[str]) -> dict:
    """The one-card legs, over a one-rank NCCL group on card 0."""
    import horovod_tpu_torch.checkpoint as ckpt
    from horovod_tpu_torch import Trainer, build_mesh
    from horovod_tpu_torch.ops import flash_attention as fa
    out: dict = {}
    steps = sum(SHARD_STEPS)
    with _one_rank_nccl():
        mesh = build_mesh()
        batch = _shard_text(SHARD["batch"], SHARD["seq"], seed=0)
        model = _shard_gpt()
        out["validate"] = _shard_rules(SHARD_TP).validate(mesh, model)
        if out["validate"]:
            problems.append(f"shard: the canonical table on "
                            f"{SHARD['gpt']}: {out['validate']}")
        plain = shard_train(model, mesh, steps, batch, warmup=SHARD_STEPS[0])
        del model
        _free()
        model = _shard_gpt()
        ruled = shard_train(model, mesh, steps, batch, table=SHARD_TP,
                            warmup=SHARD_STEPS[0], keep=True)
        launches = fa.launch_counts()
        out["mesh-of-one"] = {
            "losses": ruled["losses"], "plain_losses": plain["losses"],
            "bitwise": ruled["losses"] == plain["losses"]
            and ruled["digest"] == plain["digest"],
            "step_ms": ruled["timed_step_ms_mean"],
            "plain_step_ms": plain["timed_step_ms_mean"],
            "launches_per_step": ruled["launches_per_step"]}
        if not out["mesh-of-one"]["bitwise"]:
            problems.append("shard: the Trainer with the tp table on a mesh "
                            "of one is not the plain step bit for bit")
        with tempfile.TemporaryDirectory(prefix="shard") as tmp:
            t0 = time.perf_counter()
            ckpt.save_checkpoint(os.path.join(tmp, "ruled"), ruled["state"])
            save_s = time.perf_counter() - t0
            del ruled["trainer"], ruled["state"], model
            _free()
            model = _shard_gpt()
            opt = torch.optim.AdamW(model.parameters(), lr=CARDS_LR,
                                    weight_decay=CARDS_WD)
            fresh = Trainer(model, opt, mesh).init()
            t0 = time.perf_counter()
            restored = ckpt.restore_checkpoint(os.path.join(tmp, "ruled"),
                                               fresh)
            restore_s = time.perf_counter() - t0
            out["checkpoint"] = {
                "save_s": save_s, "restore_s": restore_s,
                "bitwise": _whole_digest(restored) == plain["digest"]
                and restored.step == steps}
            del fresh, restored, model, opt
            _free()
        if not out["checkpoint"]["bitwise"]:
            problems.append("shard: the checkpoint round trip is not "
                            "bitwise")
        split = {}
        for name, table in (("plain", None), ("tp-path", SHARD_TP)):
            model = _shard_gpt()
            split[name] = shard_train(model, mesh, SHARD_CHECK_STEPS, batch,
                                      table=table, sync_kw={"axes": ()})
            del model
            _free()
        out["tp-at-one"] = {
            "losses": split["tp-path"]["losses"],
            "split_layers": split["tp-path"]["split_layers"],
            "bitwise": split["tp-path"]["losses"] == split["plain"]["losses"]
            and split["tp-path"]["digest"] == split["plain"]["digest"]}
        if not out["tp-at-one"]["bitwise"] \
                or out["tp-at-one"]["split_layers"] == 0:
            problems.append(f"shard: the tp path at tp=1 is not the plain "
                            f"path bit for bit ({out['tp-at-one']})")
    out["losses"] = plain["losses"]
    out["launches"] = launches
    return out


def _shard_leg_tp(ctx: dict) -> dict:
    """(a) pure-GSPMD tp=n: every rank the whole batch, the layers on their
    chunks (H/n heads a rank through the flash kernels), the kernels held
    against their plain versions at that head count, then the state saved
    (gathered; rank 0 writes) for (f)."""
    import horovod_tpu_torch.checkpoint as ckpt
    from horovod_tpu_torch import build_mesh
    n = ctx["n"]
    mesh = build_mesh(tp=n)
    model = _shard_gpt(mesh)
    batch = _shard_text(SHARD["batch"], SHARD["seq"], seed=0)
    reckoned = _reckoned_bytes(model, mesh, SHARD_TP)
    out = shard_train(model, mesh, sum(SHARD_STEPS), batch, table=SHARD_TP,
                      sync_kw={"axes": ()}, warmup=SHARD_STEPS[0],
                      profile=True, keep=True)
    out["reckoned_bytes"] = reckoned
    heads = model.cfg.num_heads // n
    out["heads_per_rank"] = heads
    if _rank_device().type == "cuda":
        # The split's all-reduces alone, on the card, back to back: one
        # at each attention and MLP output forward and at each input
        # backward; and the replicated leaves' gradient average over tp.
        import torch.distributed as dist
        group = mesh.groups["tp"]
        act = torch.zeros(SHARD["batch"], SHARD["seq"], model.cfg.d_model,
                          dtype=model.cfg.dtype, device=_rank_device())
        rep = sum(p.numel() for name, p in model.named_parameters()
                  if name not in out["state"].sharding.leaves)
        grads = torch.zeros(rep, device=_rank_device())
        out["tp_allreduce"] = {
            "per_step": 4 * model.cfg.num_layers,
            "bytes": act.numel() * act.element_size(),
            "device_ms": time_ms(lambda: dist.all_reduce(act, group=group),
                                 **DEVICE),
            "replicated_grad_bytes": grads.numel() * 4,
            "replicated_grad_device_ms": time_ms(
                lambda: dist.all_reduce(grads, group=group), **DEVICE)}
        del act, grads
        shape = dict(MAIN_SHAPE, b=SHARD["batch"], h=heads, tq=SHARD["seq"],
                     tk=SHARD["seq"])
        out["kernels"] = {
            k: {kk: v[kk] for kk in ("ok", "max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms")}
            for k, v in check_kernels(shape, seed=3, measure=True).items()}
    t0 = time.perf_counter()
    ckpt.save_checkpoint(os.path.join(ctx["outdir"], "tp-ckpt"),
                         out.pop("state"))
    out["save_s"] = time.perf_counter() - t0
    del out["trainer"], model
    _free()
    return out


def _shard_pair(build, mesh, steps, batch, table, **kw) -> dict:
    """The run with ``table`` and the same run without rules."""
    runs = {}
    for label, t in (("sharded", table), ("plain", None)):
        model = build()
        reckoned = _reckoned_bytes(
            model, mesh, table,
            moments=1 if kw.get("optimizer") == "sgd" else 2)
        runs[label] = shard_train(model, mesh, steps, batch, table=t,
                                  warmup=1, **kw)
        runs[label]["reckoned_bytes"] = reckoned
        del model
        _free()
    s, p = runs["sharded"], runs["plain"]
    s["plain"] = {k: p[k] for k in ("losses", "timed_step_ms_mean",
                                    "state_bytes", "digest")
                  if k in p}
    s["plain"]["peak_memory_bytes"] = p.get("peak_memory_bytes")
    s["bitwise"] = s["losses"] == p["losses"] and s["digest"] == p["digest"]
    return s


def _shard_leg_dp_tp(ctx: dict) -> dict:
    """(b) manual dp=2 x tp=2: dp rank d takes rows [dB/2, (d+1)B/2)."""
    from horovod_tpu_torch import build_mesh
    mesh = build_mesh(dp=2, tp=ctx["n"] // 2)
    rows = SHARD["batch"] // 2
    batch = _rows(_shard_text(SHARD["batch"], SHARD["seq"], seed=0),
                  mesh.axis_index("dp"), rows)
    return _shard_pair(_shard_gpt, mesh, SHARD_CHECK_STEPS, batch, SHARD_TP)


def _shard_leg_fsdp(ctx: dict) -> dict:
    """(c) manual fsdp=n against dp=n without rules (the cards phase's
    parity leg: B/n rows a rank of the same global batch)."""
    from horovod_tpu_torch import build_mesh
    n = ctx["n"]
    batch = _rows(_shard_text(SHARD["batch"], SHARD["seq"], seed=0),
                  ctx["rank"], SHARD["batch"] // n)
    runs = {}
    for label, mesh, table in (("sharded", build_mesh(fsdp=n), SHARD_FSDP),
                               ("plain", build_mesh(dp=n), None)):
        model = _shard_gpt()
        reckoned = _reckoned_bytes(model, mesh, SHARD_FSDP)
        runs[label] = shard_train(model, mesh, CARDS_PARITY_STEPS, batch,
                                  table=table, warmup=1)
        runs[label]["reckoned_bytes"] = reckoned
        del model
        _free()
    s, p = runs["sharded"], runs["plain"]
    s["plain"] = {k: p.get(k) for k in ("losses", "timed_step_ms_mean",
                                        "state_bytes", "digest",
                                        "peak_memory_bytes")}
    s["bitwise"] = s["losses"] == p["losses"] and s["digest"] == p["digest"]
    return s


def _shard_leg_moe(ctx: dict) -> dict:
    """(d) MoE at ep=n, pure-GSPMD, each rank its row block: the experts
    held over ep against every rank holding them all (the parallel
    phase's leg (d))."""
    from horovod_tpu_torch import build_mesh
    moe, n = SHARD["moe"], ctx["n"]
    mesh = build_mesh(ep=n)
    rows = moe["batch"] // n
    batch = _rows(_shard_text(moe["batch"], moe["seq"], seed=2),
                  ctx["rank"], rows)
    return _shard_pair(
        lambda: _shard_gpt(mesh, max_seq_len=moe["seq"],
                                       moe_experts=moe["experts"]),
        mesh, SHARD_CHECK_STEPS, batch, SHARD_EXPERTS,
        sync_kw={"axes": ()}, batch_spec=("ep",))


def _shard_leg_resnet(ctx: dict) -> dict:
    """(e) ResNet-50 in bf16 with the reference's head table at manual
    dp=2 x tp=2, SGD, deterministic cuDNN (the two runs are compared bit
    for bit)."""
    from horovod_tpu_torch import build_mesh, synthetic_image_batch
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    mesh = build_mesh(dp=2, tp=ctx["n"] // 2)
    rows = SHARD["cnn_batch"] // 2
    images = synthetic_image_batch(SHARD["cnn_batch"], SHARD["image"],
                                   SHARD["resnet"]["num_classes"], seed=0)
    batch = _rows(images, mesh.axis_index("dp"), rows)
    del images
    torch.backends.cudnn.deterministic = True
    try:
        return _shard_pair(
            lambda: ResNet(block_cls=BottleneckBlock,
                                          dtype=torch.bfloat16, seed=0,
                                          **SHARD["resnet"]),
            mesh, SHARD_CHECK_STEPS, batch, SHARD_HEAD, optimizer="sgd")
    finally:
        torch.backends.cudnn.deterministic = False


def _shard_leg_restore(ctx: dict) -> dict:
    """(f) (a)'s checkpoint, saved at tp=n, restored at dp=n without
    rules: every rank's whole state is (a)'s."""
    import horovod_tpu_torch.checkpoint as ckpt
    from horovod_tpu_torch import Trainer, build_mesh
    mesh = build_mesh(dp=ctx["n"])
    model = _shard_gpt()
    opt = torch.optim.AdamW(model.parameters(), lr=CARDS_LR,
                            weight_decay=CARDS_WD)
    state = Trainer(model, opt, mesh).init()
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(os.path.join(ctx["outdir"], "tp-ckpt"), state)
    out = {"restore_s": time.perf_counter() - t0, "step": state.step,
           "digest": _whole_digest(state),
           "optimizer_state_bytes": _optimizer_bytes(opt)}
    del state, opt, model
    _free()
    return out


SHARD_LEGS = {"tp": _shard_leg_tp, "dp-tp": _shard_leg_dp_tp,
              "fsdp": _shard_leg_fsdp, "moe": _shard_leg_moe,
              "resnet": _shard_leg_resnet, "restore": _shard_leg_restore}


def shard_worker(outdir: str) -> int:
    """``chip_smoke.py --shard-worker OUTDIR``: one rank of the shard
    phase's world, started by the port's launcher; it makes its own card
    current, runs every leg in order and writes its record to
    ``OUTDIR/shard_<rank>.json`` after each.  No card: exit 3."""
    if not torch.cuda.is_available():
        print("shard worker: no CUDA device", file=sys.stderr)
        return 3
    import traceback

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import core
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    rank, n = hvd.rank(), hvd.size()
    st = core.global_state()
    rec = {"rank": rank, "size": n, "device": str(_rank_device()),
           "device_plane": st.device_plane,
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "legs": {}}
    path = os.path.join(outdir, f"shard_{rank}.json")

    def save():
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
    ctx = {"rank": rank, "n": n, "outdir": outdir}
    try:
        if not (st.device_plane and rec["backend"] == CARDS_BACKEND):
            raise RuntimeError(f"rank {rank}: no {CARDS_BACKEND} device "
                               f"plane formed ({rec})")
        for name, fn in SHARD_LEGS.items():
            t0 = time.perf_counter()
            rec["legs"][name] = fn(ctx)
            rec["legs"][name]["leg_s"] = time.perf_counter() - t0
            save()
    except BaseException:
        rec["error"] = traceback.format_exc()[-4000:]
        save()
        raise
    finally:
        hvd.shutdown()
    return 0


def _shard_world(n: int, outdir: str) -> dict:
    """``horovodrun-tpu-torch -np n`` of ``--shard-worker`` (the eager
    core's cycle at ``CARDS_QUIET_CYCLE_MS``: no eager op runs here)."""
    argv = ["-np", str(n), "-H", f"localhost:{n}", sys.executable,
            os.path.abspath(__file__), "--shard-worker", outdir]
    t0 = time.perf_counter()
    rc, text = _launcher_run(argv, {"HOROVOD_CYCLE_TIME":
                                    str(CARDS_QUIET_CYCLE_MS)},
                             timeout=SHARD_WORLD_TIMEOUT)
    recs = []
    for r in range(n):
        p = os.path.join(outdir, f"shard_{r}.json")
        if os.path.exists(p):
            with open(p) as f:
                recs.append(json.load(f))
        else:
            recs.append({"rank": r, "legs": {}})
    return {"rc": rc, "wall_s": time.perf_counter() - t0, "ranks": recs,
            "tail": text[-3000:]}


def _shard_check_world(one: dict, world: dict, n: int,
                       problems: list[str]) -> dict:
    """The four-card legs against their references and bounds."""
    recs = world["ranks"]
    out: dict = {}
    done = set.intersection(*(set(r["legs"]) for r in recs))
    missing = [k for k in SHARD_LEGS if k not in done]
    if missing:
        problems.append(f"shard world: legs {missing} did not finish")

    def same(key, leg):
        return len({json.dumps(r["legs"][leg][key]) for r in recs}) == 1

    def summary(leg, keys):
        return {k: [r["legs"][leg].get(k) for r in recs] for k in keys}
    if "tp" in done:
        a = recs[0]["legs"]["tp"]
        diffs = _loss_diffs(a["losses"], one["losses"])
        leg = {"losses": a["losses"], "one_card_losses": one["losses"],
               "loss_abs_diff_one_card": diffs,
               "heads_per_rank": a["heads_per_rank"],
               "launches_per_step": [r["legs"]["tp"]["launches_per_step"]
                                     for r in recs],
               "kernels": [r["legs"]["tp"].get("kernels") for r in recs],
               "reckoned_bytes": a["reckoned_bytes"],
               "tp_allreduce": a.get("tp_allreduce"),
               "profile": a.get("profile"),
               **summary("tp", ("state_bytes", "peak_memory_bytes",
                                "timed_step_ms_mean", "split_layers",
                                "sharded_leaves", "save_s", "leg_s"))}
        out["tp"] = leg
        if diffs[0] > CARDS_FIRST_LOSS_TOL or max(diffs) > CARDS_LOSS_TOL:
            problems.append(f"shard (a): losses {diffs} from one card's")
        if not same("losses", "tp"):
            problems.append("shard (a): the ranks' losses differ")
        for r in recs:
            t = r["legs"]["tp"]
            if any(c != _flash_per_step()
                   for c in t["launches_per_step"].values()):
                problems.append(f"shard (a) rank {r['rank']}: "
                                f"{t['launches_per_step']} launches a step")
            if t["state_bytes"] != t["reckoned_bytes"]:
                problems.append(f"shard (a) rank {r['rank']}: "
                                f"{t['state_bytes']} B held, "
                                f"{t['reckoned_bytes']} reckoned")
            if t["misplaced"]:
                problems.append(f"shard (a): {t['misplaced'][:4]} off the "
                                f"card")
            if t["split_layers"] == 0:
                problems.append("shard (a): no layer computed on its "
                                "chunks")
            bad = [k for k, v in (t.get("kernels") or {}).items()
                   if not v["ok"]]
            if bad or (_rank_device().type == "cuda"
                       and not t.get("kernels")):
                problems.append(f"shard (a) rank {r['rank']}: kernels "
                                f"{bad} disagree at {t['heads_per_rank']} "
                                f"heads")
        if SHARD["gpt"] == "gpt_small" and n == 4 \
                and a["reckoned_bytes"] != SHARD_RECKONED["tp"]:
            problems.append(f"shard (a): {a['reckoned_bytes']} B reckoned, "
                            f"not {SHARD_RECKONED['tp']}")
    for leg, tag in (("dp-tp", "b"), ("fsdp", "c"), ("moe", "d"),
                     ("resnet", "e")):
        if leg not in done:
            continue
        first = recs[0]["legs"][leg]
        rec = {"losses": first["losses"],
               "plain_losses": first["plain"]["losses"],
               "bitwise": [r["legs"][leg]["bitwise"] for r in recs],
               "reckoned_bytes": [r["legs"][leg]["reckoned_bytes"]
                                  for r in recs],
               "plain_state_bytes": [r["legs"][leg]["plain"]["state_bytes"]
                                     for r in recs],
               "plain_step_ms": [r["legs"][leg]["plain"]
                                 ["timed_step_ms_mean"] for r in recs],
               "plain_peak_memory_bytes": [r["legs"][leg]["plain"]
                                           ["peak_memory_bytes"]
                                           for r in recs],
               **summary(leg, ("state_bytes", "peak_memory_bytes",
                               "timed_step_ms_mean", "launches_per_step",
                               "sharded_leaves", "leg_s"))}
        out[leg] = rec
        for r in recs:
            x = r["legs"][leg]
            if x["state_bytes"] != x["reckoned_bytes"]:
                problems.append(f"shard ({tag}) rank {r['rank']}: "
                                f"{x['state_bytes']} B held, "
                                f"{x['reckoned_bytes']} reckoned")
            if x["misplaced"]:
                problems.append(f"shard ({tag}): {x['misplaced'][:4]} off "
                                f"the card")
            if not x["sharded_leaves"]:
                problems.append(f"shard ({tag}): nothing sharded")
        if leg == "moe":
            diff = _max_loss_diff(first["losses"], first["plain"]["losses"])
            rec["loss_max_abs_diff_unsharded"] = diff
            if diff > PARALLEL_LOSS_TOL:
                problems.append(f"shard (d): losses {diff} from the "
                                f"unsharded ep={n}'s")
        elif not all(rec["bitwise"]):
            problems.append(f"shard ({tag}): not the unsharded run bit for "
                            f"bit ({rec['bitwise']})")
        if leg == "fsdp" and SHARD["gpt"] == "gpt_small" and n == 4 \
                and rec["reckoned_bytes"][0] != SHARD_RECKONED["fsdp"]:
            problems.append(f"shard (c): {rec['reckoned_bytes'][0]} B "
                            f"reckoned, not {SHARD_RECKONED['fsdp']}")
    if {"tp", "restore"} <= done:
        digests = {r["legs"]["tp"]["digest"] for r in recs}
        f = {"restored_digest_is_tp_state": [
                 r["legs"]["restore"]["digest"] in digests for r in recs],
             "tp_step": recs[0]["legs"]["tp"]["step"],
             **summary("restore", ("step", "restore_s",
                                   "optimizer_state_bytes"))}
        out["restore"] = f
        if len(digests) != 1 or not all(f["restored_digest_is_tp_state"]) \
                or any(x != f["tp_step"] for x in f["step"]):
            problems.append("shard (f): the dp state restored from the "
                            "tp checkpoint is not the tp state")
    return out


def phase_shard() -> dict:
    """Sharded parameters (see the module docstring): the one-card legs,
    then, with four cards, the launcher's world of four ranks."""
    t_phase = time.perf_counter()
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    problems: list[str] = []
    n = torch.cuda.device_count()
    card = _smi("--query-gpu=name,power.limit",
                "--format=csv,noheader").splitlines()
    torch.cuda.empty_cache()
    one = _shard_one_card(problems)
    emit({"phase": "shard", "leg": "one-card", "card": card[:1],
          **{k: v for k, v in one.items() if k != "launches"}})
    summary: dict = {}
    if n < SHARD_CARDS:
        emit({"phase": "shard", "leg": "cards",
              "not_run": f"the machine shows {n} card(s); the legs need "
                         f"{SHARD_CARDS}"})
    else:
        with tempfile.TemporaryDirectory(prefix="shard") as outdir:
            world = _shard_world(SHARD_CARDS, outdir)
        recs = world["ranks"]
        emit({"phase": "shard", "leg": "world", "ranks": SHARD_CARDS,
              "rc": world["rc"], "wall_s": world["wall_s"],
              "device_plane": [r.get("device_plane") for r in recs],
              "devices": [r.get("device") for r in recs],
              "leg_s": {k: v.get("leg_s") for k, v in
                        recs[0]["legs"].items()}})
        if world["rc"] != 0:
            problems.append("shard world: rc {}: {}".format(
                world["rc"], " | ".join(
                    r.get("error", "")[-1200:] for r in recs
                    if r.get("error")) or world["tail"][-2000:]))
        summary = _shard_check_world(one, world, SHARD_CARDS, problems)
        for name, leg in summary.items():
            emit({"phase": "shard", "leg": name, "ranks": SHARD_CARDS,
                  **leg})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "shard", "leg": "summary", "seconds": seconds,
          "cards": n, "card": card, "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": one["launches"]}


# The perf phase: perfscope's gauges and offline tools.
PERF_TRAIN_STEPS = (WARMUP_STEPS, TIMED_STEPS)  # gpt_small: warm-up, timed
PERF_RESNET_STEPS = 3
PERF_SERVE = dict(cfg=dict(max_batch=8, token_budget=1024, max_seq=1024,
                           slo_ms=600000.0),
                  requests=8, pool=8, prompt_tokens=(16, 48), max_new=17,
                  seed=9)
PERF_SERVE_WARM = dict(PERF_SERVE, requests=2, max_new=4, seed=10)
PERF_LADDER = (4 << 10, 64 << 10, 1 << 20, 16 << 20)
PERF_LADDER_REPS = 5
PERF_HOST_RANKS = 4
PERF_CARDS = 4
PERF_MFU_TOL = 0.10                     # gauge against the synced steps
PERF_TPS_TOL = 0.25                     # serve gauge against the leg's count
PERF_WORLD_TIMEOUT = 300.0
PERF_WORKER = os.path.join("tests", "torch_perfscope_worker.py")


def peak_bf16_flops() -> float:
    """The card's dense bf16 peak, read from the port's table
    (``telemetry/perfmodel.py``), the number its MFU gauges divide by.  A
    card the table does not list fails: no bound or MFU is printed
    against a nominal peak."""
    from horovod_tpu_torch.telemetry import perfmodel
    kind = torch.cuda.get_device_name(0)
    peak = perfmodel.table_peak_flops(kind)
    if peak is None:
        raise RuntimeError(f"no peak for the card {kind!r} in "
                           "telemetry/perfmodel.PEAK_FLOPS_TABLE")
    return peak


@contextlib.contextmanager
def _metrics_on():
    """``HOROVOD_METRICS=on`` and a fresh registry; off again after."""
    from horovod_tpu_torch import telemetry
    saved = os.environ.get("HOROVOD_METRICS")
    os.environ["HOROVOD_METRICS"] = "1"
    try:
        yield telemetry.configure()
    finally:
        if saved is None:
            os.environ.pop("HOROVOD_METRICS", None)
        else:
            os.environ["HOROVOD_METRICS"] = saved
        telemetry.configure()


def _gauges(reg, names) -> dict:
    return {n: reg.gauge(n).value for n in names}


def _perf_train(reg, problems: list[str]) -> dict:
    """(a) gpt_small's ``Trainer.step`` as the train phase runs it, under
    the metrics registry: the gauges against the FLOP count and against
    the MFU of the phase's own synchronised steps."""
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_small,
                                   synthetic_text_batch)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.telemetry import perfmodel
    peak = peak_bf16_flops()
    check = check_kernels(MAIN_SHAPE, seed=3, measure=False)
    with _one_rank_nccl():
        cfg = gpt_small(attention="flash", max_seq_len=2048)
        model = TransformerLM(cfg, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        trainer = Trainer(model, opt, build_mesh(dp=1),
                          sync=GradSyncConfig(op="average",
                                              compression="bf16"))
        batch = synthetic_text_batch(8, 2048, cfg.vocab_size, seed=0)
        state = trainer.init()
        hist = reg.histogram("horovod_train_step_ms")
        torch.cuda.synchronize()
        fa.reset_launch_counts()                 # the main path starts
        step_ms, gauge_mfu, losses = [], [], []
        steps = sum(PERF_TRAIN_STEPS)
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            gauge_mfu.append(reg.gauge("horovod_train_mfu").value)
            losses.append(metrics["loss"].item())
        launches = fa.launch_counts()            # ... and ends
        trainer_peak = trainer._peak_flops
        del trainer, state, opt, model
    torch.cuda.empty_cache()
    want = perfmodel.transformer_train_flops(cfg, 8, 2048)
    timed = step_ms[PERF_TRAIN_STEPS[0]:]
    synced = want / (statistics.mean(timed) / 1e3) / peak
    # The gauge of the timed steps, averaged as the synced MFU is: the
    # count over the mean of the clock's intervals (from one step's
    # return to the next), i.e. the harmonic mean of the gauge's values.
    gauge = reg.gauge("horovod_train_mfu").value
    gauge_mean = statistics.harmonic_mean(gauge_mfu[PERF_TRAIN_STEPS[0]:])
    out = {"leg": "gpt_small", "batch": 8, "seq": 2048,
           "step_flops": reg.gauge("horovod_train_step_flops").value,
           "step_flops_count": want, "peak_flops": peak,
           "trainer_peak_flops": trainer_peak, "mfu_gauge_last": gauge,
           "mfu_gauge_timed_mean": gauge_mean, "mfu_synced": synced,
           "mfu_rel_diff": abs(gauge_mean - synced) / synced,
           "step_ms": step_ms, "timed_step_ms_mean": statistics.mean(timed),
           "gauge_step_ms": {"count": hist.count, "mean": hist.mean},
           "launches": launches,
           "launches_per_step": {k: c / steps for k, c in launches.items()},
           "kernels": {k: {"max_abs_err": v["max_abs_err"], "ok": v["ok"]}
                       for k, v in check.items()},
           "losses": losses}
    if trainer_peak != peak:
        problems.append(f"the Trainer divides by {trainer_peak}, not the "
                        f"table's {peak}")
    if out["step_flops"] != want:
        problems.append(f"train step FLOPs gauge {out['step_flops']} is "
                        f"not the count {want}")
    if abs(want - 2.0586e13) > 1e-4 * 2.0586e13:
        problems.append(f"gpt_small's count {want} is not 2.0586e13")
    if not 0.0 < gauge_mean < 1.0 or out["mfu_rel_diff"] > PERF_MFU_TOL:
        problems.append(f"train MFU gauge {gauge_mean} is not within "
                        f"{PERF_MFU_TOL:.0%} of the synced {synced}")
    for name, count in launches.items():
        if count != cfg.num_layers * steps:
            problems.append(f"{name} launched {count} times, not "
                            f"{cfg.num_layers} a step")
    bad = [k for k, v in check.items() if not v["ok"]]
    if bad:
        problems.append(f"kernels disagree with their plain versions at "
                        f"the train shape: {bad}")
    return out


def _perf_resnet(reg, problems: list[str]) -> dict:
    """(b) ResNet-50 in bf16 at B=128 for 3 steps: the step FLOPs gauge
    against the conv walk of ``resnet_forward_flops``."""
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.telemetry import perfmodel
    with _one_rank_nccl():
        model = hvt.ResNet50(seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        trainer = hvt.Trainer(model, opt, hvt.build_mesh(dp=1),
                              sync=hvt.GradSyncConfig(op="average",
                                                      compression="bf16"))
        batch = hvt.synthetic_image_batch(CNN_BATCH, 224, 1000, seed=0)
        state = trainer.init()
        step_ms = []
        for _ in range(PERF_RESNET_STEPS):
            t0 = time.perf_counter()
            state, _ = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        del trainer, state, opt, model
    torch.cuda.empty_cache()
    want = 3.0 * CNN_BATCH * perfmodel.resnet_forward_flops((3, 4, 6, 3))
    flops = reg.gauge("horovod_train_step_flops").value
    mfu = reg.gauge("horovod_train_mfu").value
    out = {"leg": "resnet50", "batch": CNN_BATCH, "dtype": "bfloat16",
           "step_flops": flops, "step_flops_count": want,
           "mfu_gauge_last": mfu,
           "mfu_last_synced": want / (step_ms[-1] / 1e3) / peak_bf16_flops(),
           "step_ms": step_ms}
    if flops != want or abs(want - 2.9629e12) > 1e-4 * 2.9629e12:
        problems.append(f"resnet50 step FLOPs gauge {flops}, count {want}: "
                        "not 2.9629e12")
    if not 0.0 < mfu < 1.0:
        problems.append(f"resnet50 MFU gauge {mfu}")
    return out


def _perf_serve(problems: list[str]) -> dict:
    """(c) one gpt_small replica (bf16, dense KV) in a world of one: a
    short first wave, then about 16 decode steps of 8 requests; the serve
    gauges against the timed wave's own count: its decoded tokens over the
    host time of its steps after the first (which prefills every prompt;
    the gauge's EMA has all but forgotten it by the wave's end)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import gpt_small
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    from horovod_tpu_torch.telemetry import perfmodel
    hvd.init()
    reg = hvd.telemetry.metrics()          # init builds the registry anew
    try:
        cfg = gpt_small()
        ex = ReplicaExecutor(ServeConfig(model_cfg=cfg,
                                         **PERF_SERVE["cfg"]))
        contexts, steps_seen = [], []
        decode, serve_step = ex._decode_once, ex._serve_step

        def record():
            decode()
            contexts.extend(s.seq_len for s in ex.slots
                            if s is not None and s.pending is None)

        def timed_step():
            before, t0 = len(contexts), time.perf_counter()
            more = serve_step()
            steps_seen.append((len(contexts) - before,
                               time.perf_counter() - t0))
            return more
        ex._decode_once, ex._serve_step = record, timed_step
        waves = {}
        for name, spec in (("warm", PERF_SERVE_WARM), ("timed", PERF_SERVE)):
            for prompt in _prompt_pool(spec, cfg.vocab_size)[
                    :spec["requests"]]:
                ex.queue.submit(prompt, spec["max_new"])
            served, steps = ex.stats["served"], ex._step
            contexts.clear()
            steps_seen.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.serve_loop(stop_when=lambda: True)
            torch.cuda.synchronize()
            waves[name] = {"wall_s": time.perf_counter() - t0,
                           "served": ex.stats["served"] - served,
                           "steps": ex._step - steps,
                           "tokens": spec["requests"] * spec["max_new"],
                           "decoded": len(contexts),
                           "step_ms": [dt * 1e3 for _, dt in steps_seen]}
        later = [(n, dt) for n, dt in steps_seen[1:] if n]
        del ex._decode_once, ex._serve_step
        ex.close()
    finally:
        hvd.shutdown()
    timed = waves["timed"]
    own_tps = sum(n for n, _ in later) / sum(dt for _, dt in later)
    names = ("horovod_serve_tokens_per_sec", "horovod_serve_flops_per_token",
             "horovod_serve_mfu")
    g = _gauges(reg, names)
    lo = perfmodel.transformer_decode_flops(cfg, min(contexts))
    hi = perfmodel.transformer_decode_flops(cfg, max(contexts))
    out = {"leg": "serve", "model": "gpt_small", "dtype": "bfloat16",
           "waves": waves, "tokens_per_s_own": own_tps,
           "tokens_per_s_wave": timed["decoded"] / timed["wall_s"],
           "gauges": g,
           "tps_rel_diff": abs(g[names[0]] - own_tps) / own_tps,
           "flops_per_token_range": [lo, hi],
           "peak_flops": peak_bf16_flops()}
    if timed["served"] != PERF_SERVE["requests"]:
        problems.append(f"serve: {timed['served']} of "
                        f"{PERF_SERVE['requests']} served")
    if not all(v > 0.0 for v in g.values()):
        problems.append(f"serve gauges not all set: {g}")
    if out["tps_rel_diff"] > PERF_TPS_TOL:
        problems.append(f"serve tokens/s gauge {g[names[0]]} is not within "
                        f"{PERF_TPS_TOL:.0%} of the leg's {own_tps}")
    if not lo <= g[names[1]] <= hi:
        problems.append(f"serve FLOPs a token {g[names[1]]} outside the "
                        f"leg's contexts' [{lo}, {hi}]")
    if abs(g[names[2]] - g[names[0]] * g[names[1]] / out["peak_flops"]) \
            > 1e-9 * g[names[2]]:
        problems.append("serve MFU gauge is not tokens/s x FLOPs a token "
                        "over the card's peak")
    return out


def _clis(calls: list[tuple[str, list[str]]], cwd: str
          ) -> list[subprocess.CompletedProcess]:
    """``python -m horovod_tpu_torch.telemetry.<tool> args`` for each
    (tool, args), all started at once (each process spends most of its
    time importing torch); their results in order."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p),
        CUDA_VISIBLE_DEVICES="")
    procs = [(subprocess.Popen(
        [sys.executable, "-m", f"horovod_tpu_torch.telemetry.{tool}",
         *args], env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), tool, args)
        for tool, args in calls]
    out = []
    for proc, tool, args in procs:
        try:
            stdout, stderr = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out.append(subprocess.CompletedProcess(proc.args, proc.returncode,
                                               stdout, stderr))
    return out


def _tool(main, argv: list[str]) -> subprocess.CompletedProcess:
    """A telemetry tool's ``main(argv)`` in this process: what its CLI
    would return and print, without another interpreter's start."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return subprocess.CompletedProcess(argv, rc, out.getvalue(),
                                       err.getvalue())


def _ledger_rows_recomputed(dumps: list[str]) -> dict:
    """(plane, op, codec, algo, bucket) -> (samples, mean busbw) from the
    dumps' busbw histograms."""
    cells: dict = {}
    for path in dumps:
        with open(path) as f:
            snap = json.load(f)
        for m in snap["metrics"]:
            if m["name"] != "horovod_collective_busbw_mbps":
                continue
            key = tuple(m["labels"][k] for k in
                        ("plane", "op", "codec", "algo", "size_bucket"))
            c = cells.setdefault(key, [0, 0.0])
            c[0] += m["count"]
            c[1] += m["sum"]
    return {k: (n, s / n) for k, (n, s) in cells.items() if n}


def _perf_tools(outdir: str, n: int, problems: list[str], tag: str,
                plane: str | None = None) -> dict:
    """The offline tools over a world's dumps and timelines: the perf
    CLI's ledger (its busbw rows against a recomputation from the
    histograms), perfcheck against itself and against a copy cut by half,
    the critical path and report's tables."""
    from horovod_tpu_torch.telemetry.perfmodel import size_bucket
    dumps = [os.path.join(outdir, f"dump.r{r}.json") for r in range(n)]
    timelines = [os.path.join(outdir, "tl.json")] + [
        os.path.join(outdir, f"tl.r{r}.json") for r in range(1, n)]
    ledger_path = os.path.join(outdir, "PERF.json")
    merged = os.path.join(outdir, "merged.json")
    perf, crit = _clis([("perf", dumps + ["-o", ledger_path, "--timeline",
                                          *timelines, "--summary"]),
                        ("trace", timelines + ["--critical-path", "-o",
                                               merged])], outdir)
    out: dict = {"perf_rc": perf.returncode,
                 "summary": perf.stderr.strip().splitlines()[:8]}
    if perf.returncode != 0:
        problems.append(f"{tag}: perf CLI rc {perf.returncode}: "
                        f"{perf.stderr[-800:]}")
        return out
    with open(ledger_path) as f:
        ledger = json.load(f)
    want = _ledger_rows_recomputed(dumps)
    rows = ledger["busbw"]
    got = {tuple(r[k] for k in ("plane", "op", "codec", "algo",
                                "size_bucket")): (r["samples"],
                                                  r["busbw_mbps"])
           for r in rows}
    out.update(world=ledger["world"], peak_mbps=ledger["peak_mbps"],
               rows=[{k: r[k] for k in ("plane", "op", "algo", "size_bucket",
                                        "samples", "busbw_mbps",
                                        "efficiency")} for r in rows],
               lost_time=ledger.get("lost_time"), step=ledger.get("step"))
    if not rows or got != want:
        problems.append(f"{tag}: the ledger's busbw rows are not the "
                        f"dumps' histograms ({len(rows)} rows)")
    if plane is not None and not any(r["plane"] == plane for r in rows):
        problems.append(f"{tag}: no {plane} rows in the ledger")
    buckets = {r["size_bucket"] for r in rows}
    for nbytes in PERF_LADDER:
        if size_bucket(nbytes) not in buckets:
            problems.append(f"{tag}: no {size_bucket(nbytes)} cell")
    cut = json.loads(json.dumps(ledger))
    for r in cut["busbw"]:
        r["busbw_mbps"] *= 0.5
    cut_path = os.path.join(outdir, "PERF.cut.json")
    with open(cut_path, "w") as f:
        json.dump(cut, f)
    from horovod_tpu_torch.telemetry import perfcheck, report
    ok = _tool(perfcheck.main, [ledger_path, "--baseline", ledger_path])
    bad = _tool(perfcheck.main, [cut_path, "--baseline", ledger_path])
    rep = _tool(report.main, [dumps[0], merged])
    findings = json.loads(bad.stdout)["findings"] if bad.stdout else []
    out["perfcheck"] = {"self_rc": ok.returncode, "cut_rc": bad.returncode,
                        "cut_stderr": bad.stderr.strip()[-400:],
                        "cut_findings": len(findings),
                        "first_finding": findings[0] if findings else None}
    if ok.returncode != 0 or bad.returncode != 1 or not findings:
        problems.append(f"{tag}: perfcheck self rc {ok.returncode}, cut rc "
                        f"{bad.returncode}, {len(findings)} findings")
    last = crit.stdout.strip().splitlines()[-1] if crit.stdout.strip() \
        else ""
    out["critical_path"] = crit.stdout.strip().splitlines()[-3:]
    if crit.returncode != 0 or not last.startswith("critical path: rank ") \
            or ", phase " not in last:
        problems.append(f"{tag}: trace --critical-path names no rank and "
                        f"phase (rc {crit.returncode}): "
                        f"{(crit.stdout + crit.stderr)[-600:]}")
    out["report_lines"] = len(rep.stdout.splitlines())
    if rep.returncode != 0 or "horovod_collective_busbw_mbps" \
            not in rep.stdout or "ALLREDUCE" not in rep.stdout:
        problems.append(f"{tag}: report rc {rep.returncode}: "
                        f"{rep.stderr[-400:]}")
    out["report_head"] = rep.stdout.splitlines()[:3]
    return out


def _perf_host_world(problems: list[str]) -> dict:
    """(d) a launcher world of four ranks on the host planes (CUDA
    hidden): the allreduce ladder of ``tests/torch_perfscope_worker.py``
    under ``HOROVOD_METRICS``, ``HOROVOD_METRICS_FILE`` and
    ``HOROVOD_TIMELINE``, then the offline tools over its files."""
    n = PERF_HOST_RANKS
    with tempfile.TemporaryDirectory(prefix="perfhost") as outdir:
        t0 = time.perf_counter()
        rc, text = _launcher_run(
            ["-np", str(n), "-H", f"localhost:{n}", sys.executable,
             PERF_WORKER, "cpu", ",".join(map(str, PERF_LADDER)),
             str(PERF_LADDER_REPS)],
            {"HOROVOD_METRICS": "1", "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "1",
             "HOROVOD_METRICS_FILE": os.path.join(outdir, "dump.json"),
             "HOROVOD_TIMELINE": os.path.join(outdir, "tl.json")},
            timeout=PERF_WORLD_TIMEOUT)
        out = {"leg": "host-world", "ranks": n, "rc": rc,
               "world_s": time.perf_counter() - t0}
        if rc != 0:
            problems.append(f"host world rc {rc}: {text[-1500:]}")
            return out
        out.update(_perf_tools(outdir, n, problems, "host world"))
    return out


def perf_card_worker(outdir: str) -> int:
    """``chip_smoke.py --perf-card-worker OUTDIR``: one rank of (e), a
    card each, under the launcher with the metrics registry, its dump and
    a timeline (``DYNAMIC``: started after one warm-up allreduce).  The
    eager NCCL allreduce ladder on the rank's card, then
    gpt_small's ``Trainer.step`` at dp=n with B=8 a card: the gauges and
    the synchronised step times go to ``OUTDIR/perf_<rank>.json``."""
    if not torch.cuda.is_available():
        print("perf card worker: no CUDA device", file=sys.stderr)
        return 3
    import traceback
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import core, telemetry
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    rank, n = hvd.rank(), hvd.size()
    dev = _rank_device()
    rec = {"rank": rank, "size": n, "device": str(dev),
           "device_plane": core.global_state().device_plane}
    try:
        if not rec["device_plane"]:
            raise RuntimeError(f"rank {rank}: no device plane formed")
        # The plane's first collective creates the NCCL communicator
        # (hundreds of ms): one allreduce before the timeline starts, so
        # that the ladder's spans are its own wire time.
        t0 = time.perf_counter()
        hvd.allreduce(torch.ones(1, device=dev), op=hvd.Sum,
                      name="perf.warm")
        torch.cuda.synchronize()
        rec["warm_ms"] = (time.perf_counter() - t0) * 1e3
        hvd.start_timeline(os.path.join(outdir, "tl.json"))
        bad = []
        for nbytes in PERF_LADDER:
            x = torch.full((nbytes // 4,), float(rank + 1), device=dev)
            for _ in range(PERF_LADDER_REPS):
                y = hvd.allreduce(x, op=hvd.Sum, name=f"ladder.{nbytes}")
                if not bool((y == n * (n + 1) / 2).all()):
                    bad.append(nbytes)
        rec["wrong_sums"] = sorted(set(bad))
        batch = _rows(_text_batch(CARDS["batch"] * n, seed=0), rank,
                      CARDS["batch"])
        _, model = _cards_gpt()
        train = cards_train(model, {"compression": "bf16"}, batch,
                            sum(PERF_TRAIN_STEPS), warmup=PERF_TRAIN_STEPS[0])
        reg = telemetry.metrics()
        rec["train"] = {k: train[k] for k in ("losses", "step_ms",
                                              "timed_step_ms_mean",
                                              "launches_per_step")}
        rec["gauges"] = _gauges(reg, ("horovod_train_step_flops",
                                      "horovod_train_mfu"))
    except BaseException:
        rec["error"] = traceback.format_exc()[-4000:]
        raise
    finally:
        with open(os.path.join(outdir, f"perf_{rank}.json"), "w") as f:
            json.dump(rec, f)
        hvd.shutdown()
    return 0


def _nccl_wire(outdir: str, n: int) -> dict:
    """Every rank's NCCL_* span time (and its longest span) against the
    wire phase the critical path gives its collectives."""
    from horovod_tpu_torch.telemetry import trace
    paths = [os.path.join(outdir, "tl.json")] + [
        os.path.join(outdir, f"tl.r{r}.json") for r in range(1, n)]
    traces = trace.load(paths)
    spans, longest = {}, {}
    for t in traces:
        opened, total, most = {}, 0.0, 0.0
        for e in t.events:
            key = (e.get("pid"), e.get("tid"))
            if e.get("ph") == "B":
                opened.setdefault(key, []).append(e)
            elif e.get("ph") == "E" and opened.get(key):
                b = opened[key].pop()
                if b.get("name", "").startswith("NCCL_") \
                        and (b.get("args") or {}).get("trace") is not None:
                    total += e["ts"] - b["ts"]
                    most = max(most, e["ts"] - b["ts"])
        spans[t.rank] = total
        longest[t.rank] = most
    phases = {}
    for ranks in trace.collective_records(traces).values():
        for r, recd in ranks.items():
            p = phases.setdefault(r, dict.fromkeys(trace.PHASES, 0.0))
            for k, v in recd.phases.items():
                p[k] += v
    return {"nccl_span_us": spans, "nccl_span_max_us": longest,
            "phases_us": phases}


def _perf_cards(problems: list[str]) -> dict:
    """(e) with four cards: the launcher's world of four ranks, one a
    card (see the module docstring)."""
    n = PERF_CARDS
    with tempfile.TemporaryDirectory(prefix="perfcards") as outdir:
        t0 = time.perf_counter()
        rc, text = _launcher_run(
            ["-np", str(n), "-H", f"localhost:{n}", sys.executable,
             os.path.abspath(__file__), "--perf-card-worker", outdir],
            {"HOROVOD_METRICS": "1",
             "HOROVOD_METRICS_FILE": os.path.join(outdir, "dump.json"),
             "HOROVOD_TIMELINE": "DYNAMIC"},
            timeout=PERF_WORLD_TIMEOUT)
        recs = []
        for r in range(n):
            p = os.path.join(outdir, f"perf_{r}.json")
            recs.append(json.load(open(p)) if os.path.exists(p) else {})
        out = {"leg": "cards", "ranks": n, "rc": rc,
               "world_s": time.perf_counter() - t0}
        if rc != 0:
            problems.append("perf cards world rc {}: {}".format(
                rc, " | ".join(r.get("error", "")[-1200:] for r in recs
                               if r.get("error")) or text[-2000:]))
            return out
        peak = peak_bf16_flops()
        from horovod_tpu_torch import gpt_small
        from horovod_tpu_torch.telemetry import perfmodel
        want = n * perfmodel.transformer_train_flops(gpt_small(), 8, 2048)
        out["train"] = []
        for r in recs:
            g, t = r["gauges"], r["train"]
            synced = want / (t["timed_step_ms_mean"] / 1e3) / (n * peak)
            out["train"].append({
                "rank": r["rank"], "step_flops": g["horovod_train_step_flops"],
                "mfu_gauge_last": g["horovod_train_mfu"],
                "mfu_synced": synced,
                "timed_step_ms_mean": t["timed_step_ms_mean"],
                "launches_per_step": t["launches_per_step"],
                "warm_ms": r["warm_ms"], "wrong_sums": r["wrong_sums"]})
            if g["horovod_train_step_flops"] != want:
                problems.append(f"cards rank {r['rank']}: step FLOPs "
                                f"{g['horovod_train_step_flops']}, not "
                                f"{n} x the one-card count")
            if not 0.0 < g["horovod_train_mfu"] < 1.0:
                problems.append(f"cards rank {r['rank']}: MFU gauge "
                                f"{g['horovod_train_mfu']}")
            if r["wrong_sums"]:
                problems.append(f"cards rank {r['rank']}: wrong sums")
        out["mesh_peak_flops"] = n * peak
        out["wire"] = _nccl_wire(outdir, n)
        for rank, span in out["wire"]["nccl_span_us"].items():
            wire = out["wire"]["phases_us"].get(rank, {}).get("wire", 0.0)
            if span <= 0.0 or wire < span:
                problems.append(f"cards rank {rank}: NCCL spans {span} us, "
                                f"wire phase {wire} us")
        out.update(_perf_tools(outdir, n, problems, "cards world",
                               plane="nccl"))
    return out


def phase_perf() -> dict:
    """perfscope on the card (see the module docstring): the gauges of
    the Trainer and the replica, a host world through the offline tools,
    and with four cards the NCCL world."""
    from horovod_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    problems: list[str] = []
    card = _smi("--query-gpu=name,power.limit",
                "--format=csv,noheader").splitlines()[:1]
    torch.cuda.empty_cache()
    legs = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        legs[name] = fn(*args, problems)
        legs[name]["leg_s"] = time.perf_counter() - t0
    with _metrics_on() as reg:
        run("gpt_small", _perf_train, reg)
        run("resnet50", _perf_resnet, reg)
    with _metrics_on():                  # hvd.init() builds the registry
        run("serve", _perf_serve)
    for leg in legs.values():
        emit({"phase": "perf", "card": card, **leg})
    launches = legs["gpt_small"]["launches"]
    run("host", _perf_host_world)
    emit({"phase": "perf", **legs["host"]})
    n = torch.cuda.device_count()
    if n < PERF_CARDS:
        emit({"phase": "perf", "leg": "cards",
              "not_run": f"the machine shows {n} card(s); the leg needs "
                         f"{PERF_CARDS}"})
    else:
        emit({"phase": "perf", **_perf_cards(problems)})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "perf", "leg": "summary", "seconds": seconds,
          "card": card, "flash_launches": launches, "problems": problems})
    fa.reset_launch_counts()
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": launches}


# The control-plane phase: the lease of every replica pair, the gpt_small
# world's steps (the kill fires at the exchange of step CP_KILL_STEP), its
# fault timeout (heartbeats every eighth of it), the coordpause's length,
# the WAL legs' writers and puts, and leg (d)'s kill (the incumbents'
# second exchange, before the joiner is let in).
CP_LEASE_MS = 500.0
CP_STEPS = 5
CP_KILL_STEP = 3
CP_KILL = f"coordkill:name=ss.grads.{CP_KILL_STEP - 1}"
CP_FAULT_TIMEOUT = 20.0
# The shared-memory plane's region for (a)'s exchange: gpt_small's
# gradients in bf16 (381 MB) in one fused response; the default 64 MiB
# region sends them over the TCP ring, several seconds a step.
CP_SHM_CAPACITY = 512 << 20
CP_PAUSE_MS = 2000
CP_WRITERS = 64
CP_WRITER_PUTS = 8
CP_PUTS = 200
CP_WORLD_TIMEOUT = 300.0
CP_CARDS = 4
CP_CARDS_KILL = "coordkill:name=ss.grads.1"
MPIRUN_STUB = '''#!/usr/bin/env python3
import os, subprocess, sys
argv = sys.argv[1:]
if argv and argv[0] == "--version":
    print("Open MPI 4.1.0"); sys.exit(0)
arity = {"-np": 1, "-H": 1, "-bind-to": 1, "-map-by": 1, "-mca": 2,
         "-x": 1, "--allow-run-as-root": 0}
np = 1; i = 0
while i < len(argv):
    if argv[i] in arity:
        if argv[i] == "-np":
            np = int(argv[i + 1])
        i += 1 + arity[argv[i]]
    else:
        break
procs = []
for r in range(np):
    env = dict(os.environ)
    env["OMPI_COMM_WORLD_RANK"] = str(r)
    env["OMPI_COMM_WORLD_SIZE"] = str(np)
    procs.append(subprocess.Popen(argv[i:], env=env))
sys.exit(max(p.wait() for p in procs))
'''


def _package_root() -> str:
    """The checkout that holds ``horovod_tpu_torch``."""
    import horovod_tpu_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        horovod_tpu_torch.__file__)))


def _wal_parent() -> str:
    """Where the phase puts its logs: the temporary directory when a
    block device holds it, else the checkout; never a tmpfs when either
    is on a disk (the WAL's fsync is what leg (c) measures)."""
    tmp, checkout = tempfile.gettempdir(), _package_root()
    disk = _disk_of(tmp)
    if disk["device"] and disk["device"].startswith("/dev/") and \
            disk["fstype"] not in ("tmpfs", "ramfs"):
        return tmp
    return checkout


def _disk_of(path: str) -> dict:
    """The mount that holds ``path``: device, mount point, file system
    (the longest mount point of ``/proc/mounts`` that prefixes it)."""
    path = os.path.realpath(path)
    best = {"device": None, "mount": "", "fstype": None}
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best["mount"]):
                best = {"device": dev, "mount": mnt, "fstype": fstype}
    return best


class _Replicas:
    """One rendezvous primary as its own process (``python -m
    horovod_tpu_torch.runner.controlplane``, the chaos target) and one
    standby in this process over the same WAL directory; a thread stamps
    the primary's death and the standby's promotion on the wall clock.
    The primary is spawned at construction and the standby built by
    ``start`` (the primary's imports, seconds, overlap across pairs; the
    standby's metrics go to the registry of the time ``start`` runs)."""

    def __init__(self, wal_dir: str, lease_ms: float = CP_LEASE_MS):
        here = _package_root()
        self.wal_dir = wal_dir
        self.lease_ms = lease_ms
        self.ports = [_free_port(), _free_port()]
        self.seeds = [f"127.0.0.1:{p}" for p in self.ports]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.controlplane",
             "--port", str(self.ports[0]), "--wal-dir", wal_dir,
             "--replica-id", "0", "--endpoints", ",".join(self.seeds),
             "--lease-ms", str(lease_ms)],
            cwd=here, env=dict(os.environ, PYTHONPATH=here),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.standby = None
        self.t_dead = self.t_promoted = None
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._stamp, daemon=True)

    def start(self) -> "_Replicas":
        from horovod_tpu_torch.runner.network import RendezvousServer
        ready = self.proc.stdout.readline()
        if ready != f"READY {self.ports[0]} {self.proc.pid}\n":
            self.proc.kill()
            raise RuntimeError(f"the primary did not start: {ready!r} "
                               f"{self.proc.stdout.read()[-2000:]}")
        # Drained, so that the primary's log lines never fill the pipe.
        threading.Thread(target=self.proc.stdout.read, daemon=True).start()
        self.standby = RendezvousServer(
            port=self.ports[1], wal_dir=self.wal_dir, replica_id=1,
            endpoints=self.seeds, lease_ms=self.lease_ms, standby=True)
        self.standby.start()
        self._watch.start()
        return self

    def _stamp(self) -> None:
        cp = self.standby.controlplane
        while not self._stop.wait(0.002):
            if self.t_dead is None and self.proc.poll() is not None:
                self.t_dead = time.time()
            if self.t_promoted is None and cp.role == "primary":
                self.t_promoted = time.time()

    def digest_is_the_log(self) -> dict:
        """The standby's live digest against a replay of the log, once
        the writers are done.  A standby that is still a standby mirrors
        the tail a poll behind: it gets 3 s to catch up."""
        from horovod_tpu_torch.runner import controlplane
        t0 = time.perf_counter()
        while True:
            state = controlplane.replay_state(
                controlplane.wal_path(self.wal_dir))
            live = self.standby.kv_digest()
            if live == state["digest"] or time.perf_counter() - t0 > 3.0:
                break
            time.sleep(0.05)
        return {"live": live, "replay": state["digest"],
                "equal": live == state["digest"],
                "wait_ms": (time.perf_counter() - t0) * 1e3,
                "epoch": state["epoch"], "leader_id": state["leader_id"]}

    def close(self) -> None:
        self._stop.set()
        if self._watch.is_alive():
            self._watch.join(timeout=5.0)
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=10)
        if self.standby is not None:
            self.standby.stop()


def _cp_counters(reg) -> dict:
    """This process's control-plane counters (both standbys of leg (a)
    and (b)'s replicas count into them) and the role gauge by replica."""
    out = {}
    for e in reg.snapshot()["metrics"]:
        if e["name"] in ("horovod_rendezvous_wal_records_total",
                         "horovod_rendezvous_wal_commit_batches_total",
                         "horovod_rendezvous_failovers_total"):
            out[e["name"]] = out.get(e["name"], 0) + e["value"]
    return out


def cp_worker(rank: int, seeds: str, outdir: str) -> int:
    """``chip_smoke.py --cp-worker RANK SEEDS OUTDIR``: one rank of leg
    (a)'s world of two on card 0 over the seed list, heartbeats and the
    statesync membership watcher on: gpt_small as the statesync phase's
    user loop trains it (``_ss_train_step``: the train phase's batch of
    B=8, four rows a rank), a step boundary after each step, then the
    state's digest on both ranks.  Its record goes to
    ``OUTDIR/cp_<rank>.json``."""
    if not torch.cuda.is_available():
        print("control-plane worker: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ.update(HOROVOD_GLOO_RENDEZVOUS_ADDR=seeds,
                      HOROVOD_GLOO_RENDEZVOUS_PORT=seeds.split(",")[0]
                      .rsplit(":", 1)[1],
                      HOROVOD_RANK=str(rank), HOROVOD_SIZE="2")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import (core, resilience, statesync,
                                   synthetic_text_batch)
    from horovod_tpu_torch.checkpoint import train_state_tree
    hvd.init()
    rec = {"rank": rank, "steps": [], "failed": [], "boundary_ms": []}
    try:
        state = _ss_train_state(seed=0)
        batch = _rows(synthetic_text_batch(8, 2048,
                                           state.model.cfg.vocab_size,
                                           seed=0), rank, 4)
        svc = statesync.StateSyncService(lambda: train_state_tree(state))
        res = resilience.active_state()
        rec["heartbeats"] = res is not None
        for _ in range(CP_STEPS):
            try:
                step = _ss_train_step(hvd, core, state, batch,
                                      host_dtype=torch.bfloat16)
            except Exception as exc:
                rec["failed"].append(f"{type(exc).__name__}: {exc}")
                raise
            engine = resilience.chaos.active()
            step["chaos_fired"] = 0 if engine is None else \
                sum(a.fired for a in engine.actions)
            rec["steps"].append(step)
            t0 = time.perf_counter()
            change = svc.step_boundary()
            rec["boundary_ms"].append((time.perf_counter() - t0) * 1e3)
            if change is not None:
                rec["failed"].append(f"world change {change.kind}")
        rec["digest"] = _ss_digest(hvd, state, "cp.digest")
        from horovod_tpu_torch.backend.shm import ShmWorld
        rec["shm_formed"] = any(isinstance(r, ShmWorld) and r.formed
                                for r in core.global_state().resources)
        rec["failed_ranks"] = sorted(res.failed_ranks()) if res else None
        svc.close()
    finally:
        with open(os.path.join(outdir, f"cp_{rank}.json"), "w") as f:
            json.dump(rec, f)
        hvd.shutdown()
    return 0


def _shm_free() -> int:
    """Bytes free where the shared-memory plane puts its regions."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return 0
    return st.f_bavail * st.f_frsize


def _cp_world(rep: _Replicas, outdir: str, chaos: str | None,
              epoch: str, shm_capacity: int | None
              ) -> tuple[list[dict], list[str]]:
    """Leg (a)'s world: two ``--cp-worker`` ranks on card 0 dialing the
    replica set; returns their records and the failures."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    if shm_capacity:
        env["HOROVOD_SHM_CAPACITY"] = str(shm_capacity)
    env.update(HOROVOD_FAULT_TOLERANCE="1",
               HOROVOD_FAULT_TIMEOUT=str(CP_FAULT_TIMEOUT),
               HOROVOD_GLOO_TIMEOUT_SECONDS="120",
               HOROVOD_RENDEZVOUS_EPOCH=epoch)
    if chaos:
        env["HOROVOD_CHAOS"] = chaos
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cp-worker", str(r),
         ",".join(rep.seeds), outdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    failures, t_end = [], time.monotonic() + CP_WORLD_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"rank {r} timed out")
            if p.returncode != 0:
                failures.append(f"rank {r} rc={p.returncode}: {out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for r in range(2):
        path = os.path.join(outdir, f"cp_{r}.json")
        recs.append(json.load(open(path)) if os.path.exists(path) else {})
    return recs, failures


def _cp_pause(rep: _Replicas, problems: list[str]) -> dict:
    """(b) ``coordpause`` past the lease: the port's chaos engine SIGSTOPs
    the primary of ``rep`` for CP_PAUSE_MS; the standby promotes; on
    SIGCONT the old primary demotes and answers 409 naming the new
    leader; every acknowledged write is read back through the seed
    list."""
    import urllib.error
    from urllib import request as urlrequest

    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.runner.network import RendezvousClient
    out = {"leg": "b-coordpause", "lease_ms": CP_LEASE_MS,
           "pause_ms": CP_PAUSE_MS}
    try:
        seeds = ",".join(rep.seeds)
        client = RendezvousClient(seeds, timeout=15.0)
        acked = {}
        for i in range(16):
            client.put("cp", f"pre{i}", b"%d" % i)
            acked[f"pre{i}"] = b"%d" % i
        saved = {k: os.environ.get(k) for k in (
            "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT")}
        os.environ.update(HOROVOD_GLOO_RENDEZVOUS_ADDR=seeds,
                          HOROVOD_GLOO_RENDEZVOUS_PORT=rep.seeds[0]
                          .rsplit(":", 1)[1])
        try:
            engine = chaos.ChaosEngine(
                f"coordpause:at=0,ms={CP_PAUSE_MS}", rank=0)
            t_stop = time.time()
            engine.on_response(["cp.pause"])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # Writes while the primary sleeps: each waits for the promotion.
        t0 = time.perf_counter()
        client.put("cp", "during", b"1")
        acked["during"] = b"1"
        out["first_write_in_pause_ms"] = (time.perf_counter() - t0) * 1e3
        for i in range(16):
            client.put("cp", f"mid{i}", b"%d" % i)
            acked[f"mid{i}"] = b"%d" % i
        out["stop_to_promotion_ms"] = None if rep.t_promoted is None \
            else (rep.t_promoted - t_stop) * 1e3
        old = RendezvousClient(rep.seeds[0], timeout=5.0)
        deadline = time.monotonic() + 10.0 + CP_PAUSE_MS / 1e3
        role = ""
        while time.monotonic() < deadline:
            try:
                role = old.probe() or ""
            except OSError:
                role = ""
            if role.startswith("standby"):
                break
            time.sleep(0.01)
        out["resume_to_demotion_ms"] = (time.time() - t_stop) * 1e3 \
            - CP_PAUSE_MS
        out["old_primary_role"] = role
        req = urlrequest.Request(f"http://{rep.seeds[0]}/cp/late",
                                 data=b"x", method="PUT")
        try:
            urlrequest.urlopen(req, timeout=5.0)
            out["old_primary_put"] = 200
        except urllib.error.HTTPError as exc:
            out["old_primary_put"] = exc.code
            out["leader_hint"] = exc.headers.get("X-Hvd-Leader")
        seeded = RendezvousClient(seeds, timeout=15.0)
        lost = [k for k, v in acked.items() if seeded.get("cp", k) != v]
        out.update(acked=len(acked), lost=lost,
                   standby_role=rep.standby.controlplane.role,
                   failovers=rep.standby.controlplane.failovers,
                   digest=rep.digest_is_the_log(),
                   primary_alive=rep.proc.poll() is None)
    finally:
        rep.close()
    emit({"phase": "controlplane", **out})
    tag = "controlplane (b)"
    if out.get("old_primary_role", "")[:7] != "standby" or \
            out.get("old_primary_put") != 409 or \
            out.get("leader_hint") != rep.seeds[1]:
        problems.append(f"{tag}: the resumed primary did not fence itself: "
                        f"{out.get('old_primary_role')!r}, "
                        f"{out.get('old_primary_put')}, "
                        f"{out.get('leader_hint')}")
    if out.get("lost") or out.get("standby_role") != "primary" or \
            out.get("failovers") != 1 or not out["digest"]["equal"] or \
            not out.get("primary_alive"):
        problems.append(f"{tag}: {out}")
    return out


def _cp_wal_cost(root: str, problems: list[str]) -> dict:
    """(c) The WAL on this machine's disk: 64 stamps in one ``put_many``
    (the host group's fan-in) and 64 writer threads at once, each batch's
    fsync timed; a ``put``'s latency with the log against the in-memory
    server."""
    from horovod_tpu_torch.runner import controlplane
    from horovod_tpu_torch.runner.network import (RendezvousClient,
                                                  RendezvousServer)
    flushes: list[tuple[int, float]] = []

    class TimedWal(controlplane.WalWriter):
        def _flush(self, batch):
            t0 = time.perf_counter()
            super()._flush(batch)
            flushes.append((len(batch), (time.perf_counter() - t0) * 1e3))

    def puts(port: int) -> list[float]:
        client = RendezvousClient(f"127.0.0.1:{port}", timeout=10.0)
        ms = []
        for i in range(CP_PUTS):
            t0 = time.perf_counter()
            client.put("lat", f"k{i % 16}", b"%d" % i)
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)

    def pct(ms, q):
        return ms[min(len(ms) - 1, int(q * len(ms)))]

    def settled(records: int) -> list:
        """The timed batches once they hold ``records`` records (a
        writer acks inside ``_flush``, before its timing is appended),
        then a fresh list."""
        t_end = time.monotonic() + 2.0
        while sum(n for n, _ in flushes) < records and \
                time.monotonic() < t_end:
            time.sleep(0.001)
        out = list(flushes)
        flushes.clear()
        return out

    wal_dir = os.path.join(root, "cost")
    out = {"leg": "c-wal-cost", "disk": _disk_of(root),
           "candidates": {"tmpdir": _disk_of(tempfile.gettempdir()),
                          "checkout": _disk_of(_package_root())}}
    saved = controlplane.WalWriter
    controlplane.WalWriter = TimedWal
    try:
        # A lease far longer than the leg: no renewal joins its batches.
        server = RendezvousServer(wal_dir=wal_dir, lease_ms=600e3)
        port = server.start()
        try:
            client = RendezvousClient(f"127.0.0.1:{port}", timeout=10.0)
            flushes.clear()
            client.put_many([("hb", f"fleet:{i}", b"%d|1" % i)
                             for i in range(CP_WRITERS)])
            fan_in = settled(CP_WRITERS)

            def writer(w):
                c = RendezvousClient(f"127.0.0.1:{port}", timeout=30.0)
                for i in range(CP_WRITER_PUTS):
                    c.put("hb", f"w{w}", b"%d" % i)
            threads = [threading.Thread(target=writer, args=(w,))
                       for w in range(CP_WRITERS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            writers_s = time.perf_counter() - t0
            concurrent = settled(CP_WRITERS * CP_WRITER_PUTS)
            out["last_values_ok"] = all(
                client.get("hb", f"w{w}") == b"%d" % (CP_WRITER_PUTS - 1)
                for w in range(CP_WRITERS))
            wal_ms = puts(port)
            out["digest_equal"] = server.kv_digest() == \
                controlplane.replay_state(
                    controlplane.wal_path(wal_dir))["digest"]
        finally:
            server.stop()
    finally:
        controlplane.WalWriter = saved
    mem = RendezvousServer()
    mem_port = mem.start()
    try:
        mem_ms = puts(mem_port)
    finally:
        mem.stop()
    fsync_ms = sorted(ms for _, ms in concurrent)
    out.update(
        fan_in={"records": sum(n for n, _ in fan_in),
                "batches": len(fan_in),
                "flush_ms": [ms for _, ms in fan_in]},
        writers={"writers": CP_WRITERS, "puts_each": CP_WRITER_PUTS,
                 # A put whose answer is lost is sent again (the client
                 # retries idempotent verbs): records may exceed the puts.
                 "records": sum(n for n, _ in concurrent),
                 "batches": len(concurrent),
                 "records_per_batch_max": max(n for n, _ in concurrent),
                 "flush_ms_p50": pct(fsync_ms, 0.5),
                 "flush_ms_p99": pct(fsync_ms, 0.99), "wall_s": writers_s,
                 "puts_per_s": CP_WRITERS * CP_WRITER_PUTS / writers_s},
        put_ms={"wal_p50": pct(wal_ms, 0.5), "wal_p99": pct(wal_ms, 0.99),
                "memory_p50": pct(mem_ms, 0.5),
                "memory_p99": pct(mem_ms, 0.99), "puts": CP_PUTS})
    emit({"phase": "controlplane", **out})
    want = CP_WRITERS * CP_WRITER_PUTS
    if out["fan_in"]["records"] != CP_WRITERS or \
            not 1 <= out["fan_in"]["batches"] <= 16 or \
            out["writers"]["records"] < want or not out["digest_equal"] \
            or out["last_values_ok"] is not True:
        problems.append(f"controlplane (c): {out}")
    return out


def _cp_train(root: str, problems: list[str]) -> dict:
    """(a) gpt_small trains at two ranks on card 0 through a coordkill of
    the rendezvous primary, beside an unbroken world of the same seed;
    (b) and (e) run at the same time (the card trains meanwhile).  (b)'s
    replicas are built before the metrics registry, so that the
    registry's control-plane counters are the kill world's standby's
    alone (the unbroken world's standby writes nothing)."""
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch import gpt_small
    layers = gpt_small().num_layers
    runs, reps, worlds, beside = {}, {}, {}, {}
    # The exchange rides the shared-memory plane when /dev/shm holds
    # both worlds' regions (one a rank), else the TCP ring.
    shm_free = _shm_free()
    shm_capacity = CP_SHM_CAPACITY \
        if shm_free >= 4 * CP_SHM_CAPACITY + (1 << 30) else None
    for mode in ("unbroken", "kill"):
        os.makedirs(os.path.join(root, mode))
        reps[mode] = _Replicas(os.path.join(root, mode, "wal"))
    pause_rep = _Replicas(os.path.join(root, "pause"))
    pool = ThreadPoolExecutor(4)
    try:
        pause_rep.start()
        with _metrics_on() as reg:
            for rep in reps.values():
                rep.start()
            t0 = time.time()
            for mode in reps:
                worlds[mode] = pool.submit(
                    _cp_world, reps[mode], os.path.join(root, mode),
                    CP_KILL if mode == "kill" else None, f"cp{mode}",
                    shm_capacity)
            beside = {"pause": pool.submit(_cp_pause, pause_rep, problems),
                      "mpirun": pool.submit(_cp_mpirun, root, problems)}
            for mode, rep in reps.items():
                recs, failures = worlds[mode].result()
                runs[mode] = {"recs": recs, "failures": failures,
                              "wall_s": time.time() - t0,
                              "t_dead": rep.t_dead,
                              "t_promoted": rep.t_promoted,
                              "primary_rc": rep.proc.poll(),
                              "digest": rep.digest_is_the_log(),
                              "role": rep.standby.controlplane.role,
                              "failovers":
                                  rep.standby.controlplane.failovers}
            runs["kill"]["counters"] = _cp_counters(reg)
            runs["kill"]["counters"]["horovod_rendezvous_role"] = [
                (e["labels"], e["value"]) for e in reg.snapshot()["metrics"]
                if e["name"] == "horovod_rendezvous_role"]
            beside = {k: f.result() for k, f in beside.items()}
    finally:
        pool.shutdown()
        for rep in (pause_rep, *reps.values()):
            rep.close()
    tag = "controlplane (a)"
    for mode, run in runs.items():
        if run["failures"]:
            problems.append(f"{tag} {mode}: {'; '.join(run['failures'])}")
    kill, ref = runs["kill"], runs["unbroken"]
    if kill["failures"] or ref["failures"]:
        return beside
    r0, ref0 = kill["recs"][0], ref["recs"][0]
    step_ms = [s["ms"] for s in r0["steps"]]
    ends = [s["t_end"] for s in r0["steps"]]
    after = [t for t in ends if kill["t_dead"] and t > kill["t_dead"]]
    losses = [[s["loss"] for s in r["steps"]] for r in kill["recs"]]
    ref_losses = [[s["loss"] for s in r["steps"]] for r in ref["recs"]]
    line = {"leg": "a-coordkill-train", "model": "gpt_small", "batch": 8,
            "batch_per_rank": 4, "seq": 2048, "dtype": "bfloat16",
            "optimizer": "AdamW", "ranks": "2 on card 0", "lease_ms": CP_LEASE_MS,
            "chaos": CP_KILL, "fault_timeout_s": CP_FAULT_TIMEOUT,
            "wall_s": {m: r["wall_s"] for m, r in runs.items()},
            "kill_to_promotion_ms": None if not (
                kill["t_dead"] and kill["t_promoted"])
            else (kill["t_promoted"] - kill["t_dead"]) * 1e3,
            "kill_to_next_step_end_ms": (after[0] - kill["t_dead"]) * 1e3
            if after else None,
            "fired_at_step": next((i + 1 for i, s in enumerate(r0["steps"])
                                   if s["chaos_fired"]), None),
            "killed_in_step": None if not kill["t_dead"] else
            sum(t <= kill["t_dead"] for t in ends) + 1,
            "step_ms": step_ms,
            "step_ms_unbroken": [s["ms"] for s in ref0["steps"]],
            "step_gap_max_ms": max(step_ms),
            "step_ms_median": statistics.median(step_ms),
            "boundary_ms": r0["boundary_ms"],
            "failed_steps": sum(len(r["failed"]) for r in kill["recs"]),
            "losses": losses, "losses_unbroken": ref_losses,
            "losses_bitwise_equal": losses == ref_losses,
            "digests": [r["digest"]["digests"] for r in kill["recs"]],
            "params_bitwise_equal_to_unbroken":
                r0["digest"]["digests"] == ref0["digest"]["digests"],
            "heartbeats": [r.get("heartbeats") for r in kill["recs"]],
            "failed_ranks": [r.get("failed_ranks") for r in kill["recs"]],
            "primary_rc": kill["primary_rc"], "role": kill["role"],
            "failovers": kill["failovers"],
            "counters": kill["counters"], "digest": kill["digest"],
            "wal_disk": _disk_of(root),
            "dev_shm_free": shm_free, "shm_capacity": shm_capacity,
            "shm_formed": [r.get("shm_formed") for r in kill["recs"]],
            "exchange": "bf16 host copies, shm plane"
            if shm_capacity and all(r.get("shm_formed")
                                    for r in kill["recs"])
            else "bf16 host copies, TCP ring",
            "launches_per_step": [s["launches"] for s in r0["steps"]]}
    emit({"phase": "controlplane", **line})
    if line["failed_steps"] or len(r0["steps"]) != CP_STEPS:
        problems.append(f"{tag}: {line['failed_steps']} failed steps, "
                        f"{len(r0['steps'])} run")
    if kill["primary_rc"] != -signal.SIGKILL or kill["role"] != "primary" \
            or kill["failovers"] != 1 or line["kill_to_promotion_ms"] is None:
        problems.append(f"{tag}: primary rc {kill['primary_rc']}, standby "
                        f"{kill['role']} after {kill['failovers']} failovers")
    if line["fired_at_step"] != CP_KILL_STEP:
        problems.append(f"{tag}: the coordkill fired at step "
                        f"{line['fired_at_step']}")
    if ref["role"] != "standby" or ref["failovers"] != 0:
        problems.append(f"{tag}: the unbroken run's standby took over")
    if not (kill["digest"]["equal"] and ref["digest"]["equal"]):
        problems.append(f"{tag}: live digest against the log's replay: "
                        f"{kill['digest']} {ref['digest']}")
    if not line["losses_bitwise_equal"] or \
            not line["params_bitwise_equal_to_unbroken"] or not all(
                len(set(d)) == 1 for d in line["digests"]):
        problems.append(f"{tag}: losses or parameters differ from the "
                        f"unbroken run's")
    if not all(math.isfinite(x) for row in losses for x in row):
        problems.append(f"{tag}: a loss is not finite")
    if not all(line["heartbeats"]) or any(line["failed_ranks"]):
        problems.append(f"{tag}: heartbeats {line['heartbeats']}, failed "
                        f"ranks {line['failed_ranks']}")
    if not all(_ss_launches_ok(r["steps"], layers) for r in kill["recs"]):
        problems.append(f"{tag}: flash launches not {layers} of each "
                        f"kernel on every step")
    launches = {}
    for s in r0["steps"]:
        for name, c in s["launches"].items():
            launches[name] = launches.get(name, 0) + c
    return {"line": line, "launches": launches, **beside}


def _cp_mpirun(root: str, problems: list[str]) -> dict:
    """(e) ``--use-mpi`` on the card through a stub ``mpirun`` (the
    reference test's: it starts the command once a rank with
    ``OMPI_COMM_WORLD_*``): one gpt_small rank as the elastic phase's
    static worker trains it; the rank must adopt its identity from the
    OMPI variables and the exported layout."""
    stub_dir = os.path.join(root, "mpibin")
    os.makedirs(stub_dir)
    stub = os.path.join(stub_dir, "mpirun")
    with open(stub, "w") as f:
        f.write(MPIRUN_STUB)
    os.chmod(stub, 0o755)
    outdir = os.path.join(root, "mpi")
    os.makedirs(outdir)
    t_launch = time.time()
    rc, text = _launcher_run(
        ["--use-mpi", "-np", "1", sys.executable, os.path.abspath(__file__),
         "--launch-worker", "static", outdir],
        {"PATH": stub_dir + os.pathsep + os.environ.get("PATH", "")})
    wall = time.time() - t_launch
    path = os.path.join(outdir, "static.json")
    if rc != 0 or not os.path.exists(path):
        problems.append(f"controlplane (e): launcher rc {rc}: {text[-3000:]}")
        return {}
    rec = json.load(open(path))
    env = rec["launcher_env"]
    steps = WARMUP_STEPS + TIMED_STEPS
    line = {"leg": "e-use-mpi", "command": "horovodrun-tpu-torch --use-mpi "
            "-np 1 (stub mpirun)", "wall_s": wall,
            "beside": "leg (a)'s two worlds and leg (b)",
            "launch_to_first_step_s": rec["t_first_step"] - t_launch,
            "rank_env_before_init": rec["rank_env_before_init"],
            "adopted": env, "rank": rec["rank"], "size": rec["size"],
            "losses": rec["losses"],
            "timed_step_ms_mean": statistics.mean(
                rec["step_ms"][WARMUP_STEPS:]),
            "launches_per_step": {n: c / steps
                                  for n, c in rec["launches"].items()}}
    emit({"phase": "controlplane", **line})
    if rec["rank_env_before_init"] is not None or \
            env["OMPI_COMM_WORLD_RANK"] != "0" or \
            env["HOROVOD_RANK"] != "0" or env["HOROVOD_SIZE"] != "1" or \
            env["HOROVOD_JSRUN_HOSTS"] != "localhost:1" or \
            (rec["rank"], rec["size"]) != (0, 1):
        problems.append(f"controlplane (e): identity {line}")
    if not all(math.isfinite(x) for x in rec["losses"]) or \
            any(c != 12 * steps for c in rec["launches"].values()):
        problems.append(f"controlplane (e): losses {rec['losses']}, "
                        f"launches {rec['launches']}")
    return line


def _cp_cards(root: str, problems: list[str]) -> dict:
    """(d) With four cards: gpt_small's world of three ranks on cards 0-2
    over the NCCL plane and the replica set; the chaos ``coordkill`` at
    the incumbents' second exchange, then a joiner on card 3 grows the
    world 3 -> 4 through the promoted standby (the statesync phase's
    ``train2`` roles with three incumbents)."""
    from horovod_tpu_torch import gpt_small
    layers = gpt_small().num_layers
    rep = _Replicas(os.path.join(root, "cards-wal")).start()
    outdir = os.path.join(root, "cards")
    os.makedirs(outdir)
    t0 = time.time()
    try:
        recs = _ss_world([("cp3", r, 3, r) for r in range(3)] +
                         [("cp3-joiner", 0, 0, 3)], outdir, seeds=rep.seeds)
        out = {"wall_s": time.time() - t0, "primary_rc": rep.proc.poll(),
               "role": rep.standby.controlplane.role,
               "failovers": rep.standby.controlplane.failovers,
               "t_dead": rep.t_dead, "t_promoted": rep.t_promoted,
               "digest": rep.digest_is_the_log()}
    finally:
        rep.close()
    r0, joi = recs[0], recs[3]
    grown = [s for r in recs for s in r["steps"] if s["size"] == 4]
    digests = [d for r in recs for d in r["digests"]]
    line = {"leg": "d-cards-coordkill-grow", "ranks": "3->4",
            "cards": "0-2, the joiner's 3", "chaos": CP_CARDS_KILL,
            "kill_to_promotion_ms": None if not (
                out["t_dead"] and out["t_promoted"])
            else (out["t_promoted"] - out["t_dead"]) * 1e3,
            "grow": [r.get("grow") for r in recs[:3]],
            "join": joi.get("join"),
            "step_ms_before": [s["ms"] for s in r0["steps"]
                               if s["size"] == 3],
            "grown_step_ms": [s["ms"] for s in r0["steps"]
                              if s["size"] == 4],
            "grown_plane": sorted({s["plane"] for s in grown}),
            "devices": sorted({s.get("device") for r in recs
                               for s in r["steps"]}),
            "digests": [(d["name"], d["equal"]) for d in r0["digests"]],
            "shrinks": [r.get("shrink") for r in recs],
            **{k: out[k] for k in ("wall_s", "primary_rc", "role",
                                   "failovers", "digest")}}
    emit({"phase": "controlplane", **line})
    tag = "controlplane (d)"
    if [g and g.get("size") for g in line["grow"]] != [4, 4, 4]:
        problems.append(f"{tag}: no grow to 4: {line['grow']}")
    if any(line["shrinks"]) or out["primary_rc"] != -signal.SIGKILL or \
            out["role"] != "primary" or out["failovers"] != 1 or \
            not out["digest"]["equal"]:
        problems.append(f"{tag}: {line}")
    if len(r0["digests"]) != SS_GROWN_STEPS + 1 or \
            not all(d["equal"] for d in digests) or \
            not joi.get("joined_digest_equals_stamp"):
        problems.append(f"{tag}: parameters differ across ranks: "
                        f"{line['digests']}")
    if line["grown_plane"] != ["card"] or \
            line["devices"] != [f"cuda:{c}" for c in range(4)] or \
            len(grown) != 4 * SS_GROWN_STEPS:
        problems.append(f"{tag}: grown steps {len(grown)} on "
                        f"{line['grown_plane']} {line['devices']}")
    if not all(_ss_launches_ok(r["steps"], layers) for r in recs):
        problems.append(f"{tag}: flash launches not {layers} of each "
                        f"kernel on every step")
    return line


def phase_controlplane(cards_only: bool = False) -> dict:
    """The control plane that survives its coordinator (see the module
    docstring): (a) with (b) and (e) beside its unbroken world, then (c)
    and, with four cards, (d); ``cards_only`` runs (d) alone (``--phases
    controlplane-cards``, for a four-card call)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    problems: list[str] = []
    card = _smi("--query-gpu=name,power.limit",
                "--format=csv,noheader").splitlines()[:1]
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="_cpwal", dir=_wal_parent())
    legs, train = {}, {}
    try:
        if not cards_only:
            t0 = time.perf_counter()
            train = _cp_train(root, problems)
            legs["a_b_e_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _cp_wal_cost(root, problems)
            legs["c_s"] = time.perf_counter() - t0
        n = torch.cuda.device_count()
        if n < CP_CARDS:
            emit({"phase": "controlplane", "leg": "d-cards-coordkill-grow",
                  "not_run": f"the machine shows {n} card(s); the leg "
                             f"needs {CP_CARDS}"})
        else:
            t0 = time.perf_counter()
            _cp_cards(root, problems)
            legs["d_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    launches = train.get("launches", {})
    emit({"phase": "controlplane", "leg": "summary", "seconds": seconds,
          "legs_s": legs, "card": card, "flash_launches": launches,
          "problems": problems})
    fa.reset_launch_counts()
    if problems:
        raise RuntimeError("; ".join(problems))
    return {"seconds": seconds, "launches": launches}


def main() -> int:
    t_start = time.perf_counter()
    if len(sys.argv) > 1 and sys.argv[1] == "--eager-worker":
        job, rank, size, port, outdir = sys.argv[2:7]
        return eager_worker(job, int(rank), int(size), int(port), outdir)
    if len(sys.argv) > 1 and sys.argv[1] == "--reduce-card-worker":
        rank, port, outdir = sys.argv[2:5]
        return reduce_card_worker(int(rank), int(port), outdir)
    if len(sys.argv) > 1 and sys.argv[1] == "--launch-worker":
        return launch_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-card-worker":
        rank, n, port, outdir = sys.argv[2:6]
        return parallel_card_worker(int(rank), int(n), int(port), outdir)
    if len(sys.argv) > 1 and sys.argv[1] == "--cards-worker":
        return cards_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--shard-worker":
        return shard_worker(sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == "--perf-card-worker":
        return perf_card_worker(sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == "--cp-worker":
        return cp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) > 1 and sys.argv[1] == "--statesync-worker":
        role, rank, size, port, outdir = sys.argv[2:7]
        return statesync_worker(role, int(rank), int(size), int(port),
                                outdir)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    # The fp32 products of the plain versions run in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    info = phase_device()
    phase_build()
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        phases = {"kernels": phase_kernels, "reference": phase_reference,
                  "train": phase_train, "serve": phase_serve,
                  "cnn": phase_cnn, "sync": phase_sync,
                  "eager": phase_eager, "binding": phase_binding,
                  "reduce": phase_reduce, "runtime": phase_runtime,
                  "resilience": phase_resilience, "elastic": phase_elastic,
                  "parallel": phase_parallel, "fit": phase_fit,
                  "statesync": phase_statesync, "cards": phase_cards,
                  "shard": phase_shard, "perf": phase_perf,
                  "controlplane": phase_controlplane,
                  "controlplane-cards":
                      lambda: phase_controlplane(cards_only=True)}
        for name in sys.argv[2].split(","):
            phases[name]()
        return 0
    kernels = phase_kernels()
    phase_reference()
    train = phase_train()
    phase_serve()
    cnn = phase_cnn()
    phase_sync()
    phase_eager()
    binding = phase_binding()
    phase_reduce()
    runtime = phase_runtime()
    phase_resilience()
    elastic = phase_elastic(binding)
    parallel = phase_parallel(train)
    fit = phase_fit()
    statesync = phase_statesync()
    cards = phase_cards(train)
    shard = phase_shard()
    perf = phase_perf()
    controlplane = phase_controlplane()
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": train["launches"][name],
         "cnn_launches": cnn["flash_launches"][name],
         "binding_launches": binding["launches"][name],
         "runtime_launches": runtime["launches"][name],
         "elastic_launches": elastic["launches"][name],
         "parallel_launches": parallel["launches"][name],
         "fit_launches": fit["launches"][name],
         "statesync_launches": statesync["launches"][name],
         "cards_launches": cards["launches"][name],
         "shard_launches": shard["launches"][name],
         "perf_launches": perf["launches"][name],
         "controlplane_launches": controlplane["launches"][name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         "library_device_ms": r["library_device_ms"]}
        for name, r in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
