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
  clip of ``sync`` over no axis, as the reference's does.  Only the
  batch dim may be sharded here.

Parameters sharded by ``param_rules`` (tensor parallelism, fsdp-sharded
leaves) are ROADMAP queue A item 10b.

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

import dataclasses
from typing import Callable, Sequence

import torch
from torch import nn

from .common import config
from .common.device import resolve_device
from .convert import flax_layouts
from .parallel import collectives
from .parallel.collectives import allreduce
from .parallel.grad_sync import (GradSyncConfig, init_ring_optimizer,
                                 sync_and_apply, sync_gradients)
from .parallel.mesh import (DEFAULT_AXES, Mesh, axis_size, data_axes,
                            global_batch, manual_region)


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    state); ``Trainer.step`` updates the last two in place."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

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


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


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
        if param_rules is not None:
            raise NotImplementedError(
                "param_rules (parameters sharded over mesh axes: tensor "
                "parallelism, fsdp-sharded leaves) is ROADMAP queue A "
                "item 10b")
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
            if any(_entry_axes(e) for e in self.batch_spec[1:]):
                raise NotImplementedError(
                    f"batch_spec {self.batch_spec}: the pure-GSPMD step "
                    "shards the batch dim only (other dims are ROADMAP "
                    "queue A item 10b)")
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
                          else self._ring)

    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The inputs and labels on the mesh's device; numpy arrays (a
        loader's batches) are taken too, as the reference's step takes
        them."""
        return (torch.as_tensor(_model_input(batch)).to(self.device),
                torch.as_tensor(batch["label"]).to(self.device))

    def _view(self):
        """The global view of the pure-GSPMD step, else the manual
        region, where the mesh's axis names are bound."""
        if self._gspmd:
            return global_batch(self.mesh, _entry_axes(self.batch_spec[0]))
        return manual_region(self.mesh)

    def step(self, state: TrainState, batch: dict
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        inputs, labels = self._batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        with self._view():
            logits = self.model(inputs, train=True)
            loss = self.loss_fn(logits, labels)
            # A checkpointed block's recompute, which may run on
            # autograd's own thread, re-enters the view itself.
            loss.backward()

        grads = {}
        for name in self._names:
            p = self._params[name]
            grads[name] = p.grad if p.grad is not None \
                else torch.zeros_like(p)
        if self._gspmd:
            # What XLA derives from the global loss: the mean over every
            # rank's shard of the batch.
            _average_in_place(list(grads.values()), self._metric_groups)
        group = self._sync_group
        if self._ring is not None:
            sync_and_apply(self._ring, grads,
                           {n: self._params[n] for n in self._names},
                           self._sync, group, self._layouts)
        else:
            synced = sync_gradients(grads, self._sync, group, self._layouts)
            for name, g in synced.items():
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
        return state, metrics

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
        with self._view():
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
