"""Distributed optimizer for PyTorch (the port's copy of
``horovod_tpu/torch/optimizer.py``; upstream horovod/torch/optimizer.py).

Per-parameter post-accumulate-grad hooks fire an async (optionally
grouped) allreduce the moment each gradient is ready, overlapping the
communication with the rest of the backward pass; ``synchronize()``
drains the handles and installs the reduced gradients before ``step()``.
Gradients on the card ride the NCCL device plane and stay there; hooks
register only in a world of more than one rank, as in the reference, so
at one rank the wrapped optimizer steps on the local gradients.  The int8
and uint4 compressors tag every allreduce with their wire codec, and
``op=Adasum`` returns the delta optimizer (``_DistributedAdasumOptimizer``),
whose combined delta stays on the parameter's device.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch

from ..eager import Adasum, Average, Sum, size
from .compression import Compression
from .mpi_ops import allreduce_async, grouped_allreduce_async


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1,
                 op=Average,
                 gradient_predivide_factor=1.0,
                 groups=None,
                 sparse_as_dense=False):
        # super() here is the wrapped optimizer class (SGD/Adam/...);
        # param_groups dicts carry every option, so its defaults are
        # never consulted.
        super(self.__class__, self).__init__(params)
        self._compression = Compression.resolve(compression)
        # The int8/uint4 markers leave the quantization to the planes;
        # their wire_codec tag rides every allreduce this optimizer fires.
        self._wire_codec = getattr(self._compression, "wire_codec", None)
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.backward_passes_per_step = backward_passes_per_step
        self._sparse_as_dense = sparse_as_dense

        named_parameters = list(named_parameters or [])
        if named_parameters:
            if not all(isinstance(k, str) for k, _ in named_parameters):
                raise ValueError(
                    "named_parameters should be a sequence of (name, "
                    "parameter) tuples")
            all_param_ids = {id(v) for group in self.param_groups
                             for v in group["params"]}
            named_ids = {id(v) for _, v in named_parameters}
            unnamed = all_param_ids - named_ids
            if unnamed:
                raise ValueError(
                    f"{len(unnamed)} parameters were not named; name all "
                    "parameters passed to DistributedOptimizer")
            self._parameter_names = {v: k for k, v in named_parameters}
        else:
            self._parameter_names = {
                v: f"allreduce.noname.{i}.{j}"
                for i, group in enumerate(self.param_groups)
                for j, v in enumerate(group["params"])}

        self._handles: dict = {}
        self._grad_accs: list = []
        self._requires_update: set = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {}
        self._groups = self._build_groups(groups)
        self._group_counts: dict[int, int] = {}
        if size() > 1:
            self._register_hooks()

    # -- grouping (reference: optimizer.py groups argument) ----------------
    def _build_groups(self, groups):
        params = [v for group in self.param_groups for v in group["params"]
                  if v.requires_grad]
        if groups is None:
            return None
        if isinstance(groups, int):
            if groups <= 0:
                return None
            buckets: list[list] = [[] for _ in range(min(groups,
                                                         len(params)))]
            for i, p in enumerate(params):
                buckets[i % len(buckets)].append(p)
            groups = buckets
        group_of = {}
        for gi, group in enumerate(groups):
            for p in group:
                group_of[p] = gi
        self._group_members = [list(g) for g in groups]
        return group_of

    # -- hooks (reference: optimizer.py:128-171,219-247) -------------------
    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    acc = p.register_post_accumulate_grad_hook(
                        self._make_hook(p))
                    self._grad_accs.append(acc)

    def _make_hook(self, p):
        def hook(*_):
            if p in self._handles and self._handles[p][0] is not None:
                if self._allreduce_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before call to "
                        "step(). Increase backward_passes_per_step to "
                        "accumulate gradients locally.")
            assert not p.grad.requires_grad
            assert self._allreduce_delay[p] > 0
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                if self._groups is not None and p in self._groups:
                    self._grouped_allreduce_maybe(p)
                else:
                    handle, ctx = self._allreduce_grad_async(p)
                    self._handles[p] = (handle, ctx)
        return hook

    def _grouped_allreduce_maybe(self, p):
        gi = self._groups[p]
        self._handles[p] = (None, None)
        self._group_counts[gi] = self._group_counts.get(gi, 0) + 1
        members = [q for q in self._group_members[gi]
                   if q in self._requires_update]
        if self._group_counts[gi] == len(members):
            self._group_counts[gi] = 0
            handle, ctxs = self._grouped_allreduce_grad_async(members)
            for q in members:
                self._handles[q] = (handle, ctxs)

    def _grad_for_wire(self, p) -> torch.Tensor:
        grad = p.grad
        if grad.is_sparse:
            if not self._sparse_as_dense:
                raise ValueError(
                    "Sparse gradients inside grouped allreduce require "
                    "sparse_as_dense=True; the per-parameter path handles "
                    "them via gather-based sparse_allreduce.")
            grad = grad.to_dense()
        return grad

    def _scale_factors(self):
        if self.gradient_predivide_factor != 1.0:
            # Average == pre/size ∘ post·size: splitting the division
            # controls overflow for fp16 wires
            # (reference: optimizer.py gradient_predivide_factor).
            prescale = 1.0 / self.gradient_predivide_factor
            postscale = self.gradient_predivide_factor / size() \
                if self.op == Average else self.gradient_predivide_factor
            return prescale, postscale, Sum
        return 1.0, 1.0, self.op

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        if p.grad is not None and p.grad.is_sparse and \
                not self._sparse_as_dense:
            # Gather-based sparse reduction (reference: optimizer.py
            # sparse path → mpi_ops.sparse_allreduce_async); synchronous
            # by nature, so the result installs immediately and
            # synchronize() has nothing to wait on.
            from .mpi_ops import sparse_allreduce
            p.grad = sparse_allreduce(p.grad, name=f"sparse.{name}",
                                      op=self.op)
            return None, None
        tensor_compressed, ctx = self._compression.compress(
            self._grad_for_wire(p))
        prescale, postscale, op = self._scale_factors()
        handle = allreduce_async(tensor_compressed, name=name, op=op,
                                 prescale_factor=prescale,
                                 postscale_factor=postscale,
                                 compression=self._wire_codec)
        return handle, (tensor_compressed, ctx)

    def _grouped_allreduce_grad_async(self, ps):
        name = self._parameter_names.get(ps[0])
        compressed = [self._compression.compress(self._grad_for_wire(p))
                      for p in ps]
        tensors = [t for t, _ in compressed]
        prescale, postscale, op = self._scale_factors()
        handle = grouped_allreduce_async(
            tensors, name=f"group.{name}", op=op,
            prescale_factor=prescale, postscale_factor=postscale,
            compression=self._wire_codec)
        return handle, compressed

    # -- synchronize / step (reference: optimizer.py:249-332) --------------
    def synchronize(self):
        if size() <= 1:
            self._synchronized = True
            return
        # Fire allreduce for any parameter whose hook never ran (e.g. grad
        # not produced this step but set manually).
        missing = [p for p in self._requires_update
                   if p not in self._handles]
        for p in missing:
            if p.grad is None:
                continue
            handle, ctx = self._allreduce_grad_async(p)
            self._handles[p] = (handle, ctx)

        done_handles = set()
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None:
                continue
            if id(handle) in done_handles:
                continue
            done_handles.add(id(handle))
            handle.wait().raise_if_error()

        installed = set()
        for p, (handle, ctx) in self._handles.items():
            if handle is not None and id(handle) not in installed:
                installed.add(id(handle))
                if isinstance(ctx, list):      # grouped: ctx per member
                    members = [q for q in
                               self._group_members[self._groups[p]]
                               if q in self._requires_update]
                    outputs = handle.outputs()
                    for q, (tc, c), out in zip(members, ctx, outputs):
                        self._install_grad(q, tc, c, out)
                else:
                    tc, c = ctx
                    self._install_grad(p, tc, c, handle.outputs()[0])
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._handles.clear()
        self._synchronized = True

    def _install_grad(self, p, tensor_compressed, c, out):
        out = out.reshape(tensor_compressed.shape) \
            .type(tensor_compressed.dtype)
        grad = self._compression.decompress(out, c)
        p.grad = grad.type(p.dtype).view_as(p.grad if not p.grad.is_sparse
                                            else grad)

    @contextmanager
    def skip_synchronize(self):
        """Use when calling `synchronize()` manually before `step()`
        (reference: optimizer.py skip_synchronize)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without triggering a new "
                    "backward pass; called synchronize() twice?")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """The Adasum delta optimizer (upstream torch/optimizer.py:335-503).

    Per parameter, per communication step: snapshot the starting value,
    run the WRAPPED optimizer on that parameter alone (p becomes start -
    lr·f(g)), send the parameter's delta through an Adasum allreduce,
    then apply the combined delta to the starting point.  The parameter
    is rolled back to its start until ``step()`` installs the combined
    delta, so the model never sees a half-applied local update.  The
    delta stays on the parameter's device: on the card it rides the
    device plane's Adasum."""

    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = Compression.resolve(compression)
        if getattr(self._compression, "wire_codec", None) in \
                ("int8", "uint4"):
            raise ValueError(
                "op=Adasum does not compose with quantized compression "
                "(int8/uint4); use none, fp16 or bf16.")
        self.backward_passes_per_step = backward_passes_per_step

        named_parameters = list(named_parameters or [])
        if named_parameters:
            if not all(isinstance(k, str) for k, _ in named_parameters):
                raise ValueError(
                    "named_parameters should be a sequence of (name, "
                    "parameter) tuples")
            all_param_ids = {id(v) for group in self.param_groups
                             for v in group["params"]}
            named_ids = {id(v) for _, v in named_parameters}
            unnamed = all_param_ids - named_ids
            if unnamed:
                raise ValueError(
                    f"{len(unnamed)} parameters were not named; name all "
                    "parameters passed to DistributedOptimizer")
            self._parameter_names = {v: k for k, v in named_parameters}
        else:
            self._parameter_names = {
                v: f"adasum.noname.{i}.{j}"
                for i, group in enumerate(self.param_groups)
                for j, v in enumerate(group["params"])}

        self._handles: dict = {}
        self._grad_accs: list = []
        self._requires_update: set = set()
        self._allreduce_delay = {}
        self._starting = {}
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = backward_passes_per_step
                    self._starting[p] = torch.zeros_like(
                        p, requires_grad=False)
                    if size() > 1:
                        acc = p.register_post_accumulate_grad_hook(
                            self._make_hook(p))
                        self._grad_accs.append(acc)

    def _make_hook(self, p):
        def hook(*_):
            assert self._allreduce_delay[p] > 0
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                self._handles[p] = self._delta_allreduce_async(p)
        return hook

    def _delta_allreduce_async(self, p):
        """The wrapped optimizer's step on `p` alone, then an async
        Adasum of the delta; `p` is rolled back to its start."""
        name = self._parameter_names.get(p)
        start = self._starting[p]
        start.copy_(p.detach())

        stashed = []
        for group in self.param_groups:
            stashed.append(group["params"])
            group["params"] = [p] if any(p is v for v in group["params"]) \
                else []
        try:
            super(self.__class__, self).step()
        finally:
            for params, group in zip(stashed, self.param_groups):
                group["params"] = params

        delta = p.detach() - start
        p.data.copy_(start)
        tensor_compressed, ctx = self._compression.compress(delta)
        handle = allreduce_async(tensor_compressed, name=f"adasum.{name}",
                                 op=Adasum)
        return handle, (tensor_compressed, ctx)

    def synchronize(self):
        """No-op: Adasum's synchronization is part of step()."""

    @contextmanager
    def skip_synchronize(self):
        raise AssertionError(
            "Skipping synchronization is not supported when using the "
            "Adasum optimizer.")

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        if size() <= 1:
            super(self.__class__, self).step()
            return loss
        for p in self._requires_update - set(self._handles):
            self._handles[p] = self._delta_allreduce_async(p)
        for p, (handle, (tensor_compressed, ctx)) in \
                list(self._handles.items()):
            handle.wait().raise_if_error()
            out = handle.outputs()[0].reshape(tensor_compressed.shape) \
                .type(tensor_compressed.dtype)
            delta = self._compression.decompress(out, ctx).type(p.dtype)
            start = self._starting[p]
            start.add_(delta.view_as(start))
            p.data.copy_(start)
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._handles.clear()
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1,
                         op=Average,
                         gradient_predivide_factor=1.0,
                         groups=None,
                         sparse_as_dense=False):
    """Wrap a torch optimizer for data-parallel training
    (reference: horovod/torch/optimizer.py DistributedOptimizer).

    The returned object is an instance of a dynamically created subclass
    of the input optimizer's class, so isinstance checks and LR schedulers
    keep working.  ``op=Adasum`` returns the delta-optimizer variant
    (upstream torch/optimizer.py:335-503).
    """
    if op == Adasum:
        if gradient_predivide_factor != 1.0:
            raise ValueError(
                "gradient_predivide_factor is not supported with "
                "op=Adasum (the delta, not the gradient, is reduced)")
        if groups is not None:
            raise ValueError("groups are not supported with op=Adasum")
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedAdasumOptimizer.__dict__))
        obj = cls.__new__(cls)
        _DistributedAdasumOptimizer.__init__(
            obj, optimizer.param_groups, named_parameters, compression,
            backward_passes_per_step)
        obj.load_state_dict(optimizer.state_dict())
        return obj
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    obj = cls.__new__(cls)
    _DistributedOptimizer.__init__(
        obj, optimizer.param_groups, named_parameters, compression,
        backward_passes_per_step, op, gradient_predivide_factor, groups,
        sparse_as_dense)
    obj.load_state_dict(optimizer.state_dict())
    return obj
