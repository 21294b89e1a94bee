"""The training step over a mesh, in PyTorch.

The counterpart of ``horovod_tpu/training.py``.  ``Trainer.step`` runs the
reference's step body in order:

1. forward and backward through the model on the batch's ``"image"``
   (the CNNs) or ``"input"`` (the Transformer); the loss is
   ``cross_entropy_loss``, streamed over the vocab above a threshold;
2. ``sync_gradients``: per-dtype buckets in the flax leaf order, cast to
   the wire dtype (or block-quantized, each leaf in flax's element order
   through ``convert.flax_layouts``) and averaged over the ``dp`` ranks;
3. the optimizer update, with a ``torch.optim`` optimizer;
4. the BatchNorm running statistics (``TrainState.batch_stats``, the
   model's buffers) averaged over the ``dp`` ranks in one all-reduce, as
   the reference averages ``batch_stats`` when BatchNorm has no
   ``axis_name``.  DDP's default, broadcasting rank 0's buffers, would be
   another result.  A model with an ``axis_name`` (cross-replica
   BatchNorm) averages its batch statistics itself, inside the forward,
   and the step skips this average, as the reference's does.

``Trainer.fit`` is the reference's epoch loop with its callback surface
(``callbacks.py``): ``data`` is an iterable of batches, re-iterated every
epoch, or a callable ``epoch -> iterable``; the epoch's metric sums stay
tensors on the device and are read once, at the epoch's end.

With ``GradSyncConfig(optimizer_in_ring=True)`` steps 2 and 3 are the
reference's ring branch, ``sync_and_apply``: the gradients are
reduce-scattered, a shard optimizer of the user optimizer's class steps
this rank's flat fp32 shard of the parameters, and the updated shards
are all-gathered; ``TrainState.optimizer`` is that shard optimizer, so
the optimizer state is 1/world per rank.  ``error_feedback`` does
nothing in the step, as in the reference, whose step calls
``sync_gradients`` and passes no residuals; error feedback is
``sync_gradients_ef``'s.

The loss (and, behind ``HOROVOD_TRACK_ACCURACY``, the accuracy) is
averaged over ``dp``.

Over a mesh with more axes (``sp``, ``ep``, ``fsdp``) each rank
passes its own shard of the batch, as the dp Trainer's callers do, laid
out as ``batch_spec`` says (the reference's ``PartitionSpec`` entries: a
mesh axis, a tuple of axes or None per dim; default the sync axes over
the batch dim).  The reference has two modes, and so does the port:

- **manual** (``sync.axes`` non-empty): the model sees local shards (with
  ``batch_spec=("dp", "sp")`` a ``[B/dp, T/sp]`` chunk, ring or Ulysses
  attention over ``sp``), and the gradients, the loss and the BatchNorm
  statistics are averaged over the sync axes' groups.  MoE with ``ep >
  1`` is refused here, as the reference's expert ``shard_map`` cannot
  nest in the manual one;
- **pure-GSPMD** (``sync.axes == ()``): the reference's model sees global
  shapes and XLA derives every reduction.  The port makes the same result
  explicit: the step runs inside ``parallel.mesh.global_batch``, where a
  layer that mixes rows sees the global batch (MoE routing, and the
  sequence under ring or Ulysses), and the replicated parameters'
  gradients and the loss are averaged in fp32 over every rank of the
  mesh before ``sync_gradients`` applies the wire cast, loss scale and
  clip of ``sync`` over no axis, as the reference's does.  A
  ``batch_spec`` may shard other dims too (``("dp", "sp")``: each rank
  passes its ``[B/dp, T/sp]`` shard, row-major as in the manual mode).
  A Transformer whose ring or Ulysses attention runs over the spec's
  dim-1 axis (``cfg.sp_axis``) takes that chunk as it is: the view binds
  the axis, as the reference's nested ``shard_map`` over ``P(batch_spec,
  sp_axis)`` sees it.  Any other model gets its inputs and labels
  all-gathered along those dims at the step's entry, and computes on the
  whole dims: what the reference's sharding constraint leaves of the
  function.  The loss and gradients are the global mean either way.

With ``param_rules`` (``parallel.sharding.ShardingRules`` over the flax
paths and shapes) each parameter that a rule splits over mesh axes of
more than one rank holds this rank's chunk, cut in the flax view, and
so does its optimizer state; the state stays sharded at rest after every
step (the reference's manual step hands back replicated arrays; the
numbers are the same).  Every problem ``validate`` finds is logged.

- **manual:** each sharded leaf is gathered into a transient whole
  tensor before the forward, as the reference's ``shard_map`` gathers
  its ``P()`` state; its whole gradient goes through ``sync_gradients``
  (or ``sync_and_apply``) with the others in the flax leaf order, and
  each chunk takes its slice of the result.  Every sync knob then gives
  the unsharded step's numbers bit for bit.
- **pure-GSPMD:** where the rules give a Transformer block the canonical
  tensor-parallel layout (``attn/w[qkv]/kernel`` ``P(None, A, None)``,
  ``attn/wo/kernel`` ``P(A, None, None)``, ``mlp/(gate|up)/kernel``
  ``P(None, A)``, ``mlp/down/kernel`` ``P(A, None)``, ``A`` not a batch
  axis), its layers compute on their chunks (``Attention.split``,
  ``MLP.split``), and a chunk's gradient is averaged over the mesh axes
  it is not split over; MoE experts sharded over ``ep`` on their leading
  dim are the layer's own, and their gradients are summed over the other
  axes and divided by the mesh's rank count, as the zeros of the other
  experts' ranks divide them in the unsharded step.  Any other sharded
  leaf is gathered for the forward, and its gradient, averaged with the
  replicated ones, is cut to the chunk.  ``clip_global_norm`` sums each
  chunk's squares over its axes (``sync_gradients(norm_groups=...)``).
  The quantized wires (int8, uint4) take the whole leaves, as the
  reference's blocks do: each chunk's gradient is gathered before the
  sync and cut after it.

PyTorch updates in place: ``TrainState`` holds the model and its
optimizer, and ``step`` returns the same state advanced by one step,
where the reference returns a new immutable one.

The reference's ``optax.adamw(3e-4)`` is
``torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)``: optax defaults
to a weight decay of 1e-4, torch to 1e-2; the update rules are otherwise
the same.  The reference's ``optax.sgd(0.1, momentum=0.9)`` (the CNN
benchmark's) is ``torch.optim.SGD(params, lr=0.1, momentum=0.9)``:
dampening 0 and no Nesterov, and the first step's momentum buffer is the
gradient itself in both.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Sequence

import torch
from torch import nn

from .common import config
from .common.device import resolve_device
from .common.logging import logger
from .convert import flax_layouts
from .parallel import collectives
from .parallel.collectives import allreduce
from .parallel.grad_sync import (GradSyncConfig, init_ring_optimizer,
                                 sync_and_apply, sync_gradients)
from .parallel.mesh import (DEFAULT_AXES, Mesh, axis_size, data_axes,
                            global_batch, manual_region)
from .parallel.sharding import ShardedParams, entry_axes, plan_sharding


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    state); ``Trainer.step`` updates the last two in place."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    # The Trainer's sharded parameters (param_rules), else None.
    sharding: ShardedParams | None = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The BatchNorm running statistics (empty for the Transformer)."""
        return dict(self.model.named_buffers())


# Above this many logit elements the loss streams over the vocab axis
# instead of materialising an fp32 log_softmax of the whole logits tensor
# (ops/loss.py).  The default scales with the device's memory: memory/16
# elements, i.e. room for the fp32 copy (4 bytes an element) with the bf16
# logits and their gradient beside it.
def _device_memory_bytes(device: torch.device) -> int | None:
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def _ce_threshold(device: torch.device) -> int:
    value = config.STREAMING_CE_MIN_ELEMENTS.get()
    if value is not None:
        return value
    memory = _device_memory_bytes(device)
    if memory is not None:
        return max(memory // 16, 1 << 20)
    return 1 << 30


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels (fp32 math).
    Out-of-range labels carry no one-hot mass, as ``jax.nn.one_hot``."""
    if logits.numel() >= _ce_threshold(logits.device):
        from .ops.loss import streaming_softmax_cross_entropy
        return streaming_softmax_cross_entropy(logits, labels,
                                               label_smoothing)
    vocab = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    picked = logp.gather(-1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    nll = -torch.where(valid, picked, torch.zeros_like(picked))
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            - label_smoothing * logp.mean(dim=-1)
    return nll.mean()


def _track_accuracy() -> bool:
    return bool(config.TRACK_ACCURACY.get())


def _leaf_order(model: nn.Module) -> list[str]:
    """Parameter names in the order gradient buckets are filled: the flax
    flatten order for the Transformer and the CNNs (so buckets match the
    reference), registration order otherwise."""
    from .convert import cnn_leaf_order, flax_leaf_order
    from .models import VGG, InceptionV3, ResNet, TransformerLM
    if isinstance(model, TransformerLM):
        return flax_leaf_order(model.cfg)
    if isinstance(model, (ResNet, VGG, InceptionV3)):
        return cnn_leaf_order(model)
    return [name for name, _ in model.named_parameters()]


def _model_input(batch: dict) -> torch.Tensor:
    """The model's input tensor: "image" for vision batches, "input" for
    token batches."""
    return batch["image"] if "image" in batch else batch["input"]


def _average_in_place(tensors: list[torch.Tensor], group) -> None:
    """Average the tensors over the group's (or groups') ranks in place,
    one all-reduce of their concatenation per dtype; nothing to do at one
    rank."""
    if not tensors or collectives.world_size(group) == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = allreduce(torch.cat([t.reshape(-1) for t in same]),
                         "average", group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def _spec_entries(batch_spec, axes: tuple[str, ...]) -> tuple:
    """``batch_spec`` as a tuple of per-dim entries (default: the sync
    axes over the batch dim)."""
    if batch_spec is None:
        return (tuple(axes),)
    if isinstance(batch_spec, str):
        return (batch_spec,)
    return tuple(batch_spec)



class Trainer:
    """Owns the train step.

    >>> model = TransformerLM(gpt_small(attention="flash"))
    >>> opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
    ...                         weight_decay=1e-4)
    >>> trainer = Trainer(model, opt, build_mesh(dp=1))
    >>> state = trainer.init()
    >>> state, metrics = trainer.step(state, batch)

    ``sync`` takes every reference knob; with ``optimizer_in_ring`` the
    state's optimizer is the shard optimizer, and ``error_feedback`` is
    ignored by the step, as in the reference (use ``sync_gradients_ef``).
    ``sync.axes == ()`` selects the pure-GSPMD step (see the module's
    docstring).
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 mesh: Mesh, *, sync: GradSyncConfig | None = None,
                 param_rules=None, loss_fn: Callable = cross_entropy_loss,
                 batch_spec=None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        axes = data_axes(mesh) or ("dp",)
        self.sync = sync or GradSyncConfig(axes=axes, op="average")
        self.sync.check()
        self.loss_fn = loss_fn
        self.batch_spec = _spec_entries(batch_spec, axes)
        self.device = resolve_device(mesh.device)
        self._names = _leaf_order(model)
        self._params = dict(model.named_parameters())
        self._stats = list(model.buffers())
        if sorted(self._names) != sorted(self._params):
            raise ValueError("the gradient leaf order does not name the "
                             "model's parameters")
        self._layouts = flax_layouts(model)
        self._set_groups()
        self._ring = None
        if self.sync.optimizer_in_ring:
            self._ring = init_ring_optimizer(
                optimizer, [self._params[n] for n in self._names],
                collectives.world_size(self._metric_groups), self.sync)
        self.param_rules = param_rules
        self._sharded: ShardedParams | None = None
        # The MFU gauges (telemetry/perfmodel.py): the FLOPs of the batch
        # the whole mesh consumes in one step, resolved from the first
        # batch's shape, over the peak of the mesh's cards, timed from one
        # step's return to the next (a wait for the card here would stall
        # the queue the step leaves behind).
        self._step_flops: float | None = None
        self._peak_flops: float | None = None
        self._last_step: float | None = None
        # Chunks the model computes on as they are (pure-GSPMD): name ->
        # (groups summed over, divisor).
        self._direct: dict[str, tuple[list, int]] = {}
        # The sync sees whole leaves (manual step; quantized wires, whose
        # blocks run over whole leaves as the reference's do), else the
        # chunks, whose squares the clip sums over their groups.
        self._whole_sync = not self._gspmd \
            or self.sync.compression in ("int8", "uint4")
        self._norm_groups = None
        if param_rules is not None:
            self._shard(param_rules)
        elif hasattr(model, "apply_tensor_parallel"):
            model.apply_tensor_parallel(None)    # an earlier Trainer's split

    def _axis_groups(self, axes) -> list:
        return [self.mesh.groups[a] for a in axes
                if axis_size(self.mesh, a) > 1]

    def _shard(self, rules) -> None:
        """Log the table's problems, then replace each sharded
        parameter's storage (and any optimizer state of its shape) by
        this rank's chunk."""
        mesh = self.mesh
        for problem in rules.validate(mesh, self.model):
            logger.warning("sharding rules: %s", problem)
        plan = plan_sharding(self.model, mesh, rules)
        leaves = {n: leaf for n, leaf in plan.items() if leaf.sharded}
        direct = {}
        if hasattr(self.model, "apply_tensor_parallel"):
            # The model's own split (pure-GSPMD only: the manual step
            # computes on whole leaves).
            direct = self.model.apply_tensor_parallel(
                plan if self._gspmd else None, self._axis_groups,
                entry_axes(self.batch_spec[0]))
        shapes = {n: self._params[n].shape for n in leaves}
        self._sharded = ShardedParams(mesh, leaves, shapes)
        with torch.no_grad():
            for name in leaves:
                p = self._params[name]
                p.data = self._sharded.cut(name, p.data)
                state = self.optimizer.state.get(p, {})
                for key, value in state.items():
                    if isinstance(value, torch.Tensor) \
                            and value.shape == shapes[name]:
                        state[key] = self._sharded.cut(name, value)
        if not self._whole_sync and leaves:
            self._norm_groups = {n: self._axis_groups(leaf.axes)
                                 for n, leaf in leaves.items()}
        big = [a for a in DEFAULT_AXES if axis_size(mesh, a) > 1]
        for name, megatron in direct.items():
            leaf = plan[name]
            if not leaf.sharded:
                continue        # split over one rank: a replicated leaf
            others = [a for a in big if a not in leaf.axes]
            divisor = 1
            for a in (others if megatron else big):
                divisor *= axis_size(mesh, a)
            self._direct[name] = (self._axis_groups(others), divisor)

    def _set_groups(self) -> None:
        """The groups the gradients are synced over (``_sync_group`` with
        ``_sync``), and those the loss and statistics are averaged over
        (``_metric_groups``)."""
        mesh = self.mesh
        big = [a for a in DEFAULT_AXES if axis_size(mesh, a) > 1]
        self._gspmd = not self.sync.axes
        self._sync = self.sync
        if self._gspmd:
            if self.sync.optimizer_in_ring:
                raise ValueError(
                    "optimizer_in_ring needs explicit sync axes (pure-GSPMD "
                    "mode has no manual axis to shard the update over)")
            self._plan_inputs()
            self._sync_group = {}
            self._metric_groups = [mesh.groups[a] for a in big]
        elif set(big) <= {"dp"}:
            # Only dp spans ranks: the mesh's own group is dp's.
            self._sync_group = mesh.group
            self._metric_groups = mesh.group
        else:
            cfg = getattr(self.model, "cfg", None)
            if getattr(cfg, "moe_experts", 0) > 0 \
                    and axis_size(mesh, cfg.ep_axis) > 1:
                raise ValueError(
                    "MoE over ep > 1 needs the pure-GSPMD step (sync axes "
                    "()): the expert-parallel layer cannot run inside the "
                    "manual step, as the reference's shard_map cannot nest")
            kept = tuple(a for a in self.sync.axes
                         if axis_size(mesh, a) > 1)
            self._sync_group = {a: mesh.groups[a] for a in kept}
            self._sync = dataclasses.replace(self.sync, axes=kept)
            self._metric_groups = [mesh.groups[a] for a in kept]

    def _plan_inputs(self) -> None:
        """The pure-GSPMD step's non-batch dims that ``batch_spec`` shards
        over axes of more than one rank: bound in the view where the
        model computes over them itself (``_seq_axes``), else gathered at
        the step's entry (``_gather_dims``, (dim, axes) pairs)."""
        mesh = self.mesh
        split = [(dim, tuple(a for a in entry_axes(e)
                             if axis_size(mesh, a) > 1))
                 for dim, e in enumerate(self.batch_spec) if dim > 0]
        split = [(dim, axes) for dim, axes in split if axes]
        cfg = getattr(self.model, "cfg", None)
        if cfg is not None and getattr(cfg, "attention", None) in (
                "ring", "ulysses") and not getattr(cfg, "moe_experts", 0) \
                and split == [(1, (cfg.sp_axis,))]:
            self._seq_axes, self._gather_dims = (cfg.sp_axis,), []
        else:
            self._seq_axes, self._gather_dims = (), split

    def _entry(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` all-gathered along the dims of ``_gather_dims`` it has,
        over their axes (row-major, as the shards were laid)."""
        for dim, axes in self._gather_dims:
            if dim < x.dim():
                groups = [self.mesh.groups[a] for a in axes]
                x = collectives.allgather(x.movedim(dim, 0).contiguous(),
                                          groups).movedim(0, dim)
        return x.contiguous()

    def init(self, sample_batch: dict | None = None) -> TrainState:
        """The state at step 0.  The model's parameters were drawn when
        it was built (from its generator), so every rank that builds it
        with the same seed starts from the same point."""
        del sample_batch
        for p in self.model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"model parameters lie on {p.device}, the "
                                 f"mesh's device is {self.device}")
        return TrainState(step=0, model=self.model,
                          optimizer=self.optimizer if self._ring is None
                          else self._ring, sharding=self._sharded)

    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The inputs and labels on the mesh's device, whole along the
        dims the pure-GSPMD step gathers; numpy arrays (a loader's
        batches) are taken too, as the reference's step takes them."""
        inputs = torch.as_tensor(_model_input(batch)).to(self.device)
        labels = torch.as_tensor(batch["label"]).to(self.device)
        if self._gspmd and self._gather_dims:
            return self._entry(inputs), self._entry(labels)
        return inputs, labels

    def _view(self):
        """The global view of the pure-GSPMD step, else the manual
        region, where the mesh's axis names are bound."""
        if self._gspmd:
            return global_batch(self.mesh, entry_axes(self.batch_spec[0]),
                                self._seq_axes)
        return manual_region(self.mesh)

    def _gathered(self) -> dict[str, torch.Tensor]:
        """The whole leaf of every sharded parameter the model does not
        use as a chunk (collective, in the leaf order)."""
        if self._sharded is None:
            return {}
        return {n: self._sharded.gather(n, self._params[n].data)
                for n in self._names
                if n in self._sharded.leaves and n not in self._direct}

    @contextlib.contextmanager
    def _holding(self, whole: dict[str, torch.Tensor]):
        """Inside, each parameter named in ``whole`` holds that whole
        tensor; on exit it holds its chunk again, and the whole gradient
        it took is in the yielded dict."""
        chunks, grads = {}, {}
        for name, full in whole.items():
            p = self._params[name]
            chunks[name], p.data = p.data, full
        try:
            yield grads
        finally:
            for name, chunk in chunks.items():
                p = self._params[name]
                grads[name], p.grad = p.grad, None
                p.data = chunk

    def _reduce_direct(self, grads: dict[str, torch.Tensor]) -> None:
        """Sum each chunk the model used as it is over the mesh axes it is
        not split over, and divide it (``_shard``)."""
        by_reduction: dict[tuple, list[torch.Tensor]] = {}
        for name in self._names:
            if name in self._direct:
                groups, divisor = self._direct[name]
                by_reduction.setdefault((tuple(groups), divisor),
                                        []).append(grads[name])
        for (groups, divisor), tensors in by_reduction.items():
            if not groups and divisor == 1:
                continue
            flat = torch.cat([t.reshape(-1) for t in tensors])
            flat = allreduce(flat, "sum", list(groups)) / divisor
            for t, part in zip(tensors,
                               flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))

    def step(self, state: TrainState, batch: dict
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        inputs, labels = self._batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        whole = self._gathered()
        with self._view(), self._holding(whole) as whole_grads:
            logits = self.model(inputs, train=True)
            loss = self.loss_fn(logits, labels)
            # A checkpointed block's recompute, which may run on
            # autograd's own thread, re-enters the view itself.
            loss.backward()

        grads = {}
        for name in self._names:
            p = whole.get(name, self._params[name])
            g = whole_grads[name] if name in whole else p.grad
            grads[name] = g if g is not None else torch.zeros_like(p)
        if self._gspmd:
            # What XLA derives from the global loss: the mean over every
            # rank's shard of the batch.
            _average_in_place([g for n, g in grads.items()
                               if n not in self._direct],
                              self._metric_groups)
            self._reduce_direct(grads)
            if self._whole_sync:
                for name in self._direct:
                    grads[name] = self._sharded.gather(name, grads[name])
            else:
                for name in whole:
                    grads[name] = self._sharded.cut(name, grads[name])
        group = self._sync_group
        if self._ring is not None:
            params = {n: whole.get(n, self._params[n]) for n in self._names}
            sync_and_apply(self._ring, grads, params, self._sync, group,
                           self._layouts)
            with torch.no_grad():
                for name, full in whole.items():
                    self._params[name].copy_(self._sharded.cut(name, full))
        else:
            synced = sync_gradients(grads, self._sync, group, self._layouts,
                                    self._norm_groups)
            for name, g in synced.items():
                if self._whole_sync and self._sharded is not None \
                        and name in self._sharded.leaves:
                    g = self._sharded.cut(name, g)
                self._params[name].grad = g
            self.optimizer.step()
        if getattr(self.model, "axis_name", None) is None:
            _average_in_place(self._stats, self._metric_groups)

        metrics = {"loss": allreduce(loss.detach(), "average",
                                     self._metric_groups)}
        if _track_accuracy():
            acc = (logits.detach().argmax(-1) == labels).float().mean()
            metrics["accuracy"] = allreduce(acc, "average",
                                            self._metric_groups)
        state.step += 1
        self._note_step(batch)
        return state, metrics

    def _mesh_shape(self, x) -> list[int]:
        """The shape of the input the whole mesh consumes in one step: each
        dim of this rank's shard ``x`` (as the caller passed it, before
        any gather) times the sizes of the mesh axes ``batch_spec`` names
        on it (dp and fsdp grow the batch, sp the sequence; tp and ep
        repeat it)."""
        shape = [int(n) for n in x.shape]
        for dim, entry in enumerate(self.batch_spec[:len(shape)]):
            for axis in entry_axes(entry):
                shape[dim] *= axis_size(self.mesh, axis)
        return shape

    def _note_step(self, batch: dict) -> None:
        """Fold one step into the MFU gauges under ``HOROVOD_METRICS=on``.
        The first call only arms the clock."""
        from .telemetry import metrics as telemetry_metrics
        tm = telemetry_metrics()
        if not tm.enabled:
            return
        from .telemetry import perfmodel
        now = time.monotonic()
        prev, self._last_step = self._last_step, now
        if self._step_flops is None:
            shape = self._mesh_shape(_model_input(batch))
            ndim = len(shape)
            self._step_flops = perfmodel.model_step_flops(
                self.model, shape[0] if ndim else 1,
                seq=shape[1] if ndim == 2 else 0,
                image_size=shape[1] if ndim == 4 else 224, train=True)
            tm.gauge("horovod_train_step_flops").set(self._step_flops)
        if self._peak_flops is None:
            self._peak_flops = perfmodel.peak_flops(
                perfmodel.device_kind(self.device)) * self.mesh.size
        if prev is None:
            return
        dt = now - prev
        tm.histogram("horovod_train_step_ms").observe(dt * 1e3)
        tm.gauge("horovod_train_mfu").set(
            perfmodel.mfu(self._step_flops, dt, self._peak_flops))

    def fit(self, state: TrainState, data, epochs: int = 1,
            callbacks: Sequence = (), steps_per_epoch: int | None = None):
        """The epoch loop hosting the reference's callback surface
        (reference: horovod/_keras/callbacks.py): ``data`` is an iterable
        of batches (re-iterated every epoch) or a callable ``epoch ->
        iterable``.  Returns ``(state, history)``, one dict of the
        epoch's mean metrics an epoch."""
        for cb in callbacks:
            if hasattr(cb, "set_trainer"):
                cb.set_trainer(self)
            if hasattr(cb, "set_state"):
                cb.set_state(state)
        if config.FLEET.get():
            raise NotImplementedError(
                "HOROVOD_FLEET=1: the fleet runtime (one host pool "
                "arbitrated between training and serving) is ROADMAP queue "
                "A item 12")
        history: list[dict] = []
        for cb in callbacks:
            cb.on_train_begin()
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            batches = data(epoch) if callable(data) else data
            sums: dict[str, torch.Tensor] = {}
            count = 0
            for i, batch in enumerate(batches):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                for cb in callbacks:
                    cb.on_batch_begin(i)
                state, metrics = self.step(state, batch)
                # The metrics stay on the device through the epoch: a
                # read here would wait for the step every step.
                for cb in callbacks:
                    cb.on_batch_end(i, metrics)
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
                count += 1
            epoch_logs = {k: float(v) / max(count, 1)
                          for k, v in sums.items()}
            for cb in callbacks:
                if hasattr(cb, "set_state"):
                    cb.set_state(state)
                cb.on_epoch_end(epoch, epoch_logs)
            history.append(epoch_logs)
        for cb in callbacks:
            cb.on_train_end()
        return state, history

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict
                  ) -> dict[str, torch.Tensor]:
        inputs, labels = self._batch(batch)
        with self._view(), self._holding(self._gathered()):
            logits = state.model(inputs, train=False)
        loss = self.loss_fn(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        groups = self._metric_groups
        return {"loss": allreduce(loss, "average", groups),
                "accuracy": allreduce(acc, "average", groups)}


def synthetic_text_batch(batch_size: int, seq_len: int = 2048,
                         vocab_size: int = 32000, seed: int = 0,
                         device: str | torch.device | None = None) -> dict:
    """Random next-token-prediction batch: label[t] = input[t+1].  Drawn
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                           generator=gen, device=dev)
    return {"input": tokens[:, :-1], "label": tokens[:, 1:]}


def synthetic_image_batch(batch_size: int, image_size: int = 224,
                          num_classes: int = 1000, seed: int = 0,
                          device: str | torch.device | None = None) -> dict:
    """Random NHWC fp32 images and integer labels, as the reference's
    synthetic benchmark draws them.  On the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"image": torch.randn(batch_size, image_size, image_size, 3,
                                 generator=gen, device=dev),
            "label": torch.randint(0, num_classes, (batch_size,),
                                   generator=gen, device=dev)}
