# Ported from horovod_tpu/torch/optimizer.py:1-266 (without its branch for
# a torch that lacks post-accumulate-grad hooks, which the port does not
# support).
"""``hvd.DistributedOptimizer`` for PyTorch.

Port of ``horovod_tpu/torch/optimizer.py:29-266`` (reference:
``horovod/torch/optimizer.py`` ``_DistributedOptimizer``): per-parameter
gradient hooks fire async allreduces during ``backward()``; ``step()``
calls ``synchronize()`` to wait for and apply the averaged gradients, then
runs the wrapped optimizer.  Supports ``backward_passes_per_step`` local
aggregation, compression, ``Sum`` / ``Average`` ops, pre/post-scale
factors, process sets, and ``skip_synchronize()``.  In a world of one
process no hook is registered and ``synchronize()`` returns at once.

The allreduces go through ``mpi_ops`` and the collective engine: each
gradient is submitted under its parameter's name (``allreduce.<name>``)
with its reverse-registration priority, negotiated across ranks by name,
and fused with the others of its cycle.  ``op=Adasum`` combines the
ranks' gradients by adaptive summation (``parallel/adasum.py``, over each
fused dtype buffer, as the JAX engine does): a raw Adasum with no divisor,
and ``gradient_predivide_factor`` is refused with it.  ``check=`` raises
until the analyzer is ported.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from . import mpi_ops
from .common import basics
from .common.process_sets import ProcessSet
from .compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1,
                 op=mpi_ops.Average,
                 gradient_predivide_factor=1.0,
                 process_set: Optional[ProcessSet] = None):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"allreduce.noname.{i}.{j}", v)
                                for i, group in enumerate(self.param_groups)
                                for j, v in enumerate(group["params"])]
        if len(named_parameters) > 0 and not isinstance(
                named_parameters[0][1], torch.Tensor):
            raise ValueError("named_parameters should be a sequence of "
                             "(name, torch.Tensor) pairs")
        all_params = {p for group in self.param_groups
                      for p in group["params"]}
        named = {p for _, p in named_parameters}
        unnamed = all_params - named
        if unnamed:
            raise ValueError(
                f"named_parameters was specified but {len(unnamed)} "
                f"optimizer parameters were not named")
        dups = _find_duplicates([k for k, _ in named_parameters])
        if dups:
            raise ValueError(f"Parameter names are not unique: {dups}")

        self._parameter_names = {v: k for k, v in named_parameters}
        # Reverse-registration drain priority: the first-registered
        # parameter (first layer touched by the next forward pass) gets the
        # highest priority, so its gradient — produced LAST by backprop —
        # still leads the next coordinator cycle (ByteScheduler-style
        # scheduling).  Registration order matches across ranks, so the
        # stamps agree.
        self._priorities = {p: len(named_parameters) - i
                            for i, (_, p) in enumerate(named_parameters)}
        self._handles = {}
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {}

        if basics.size() > 1:
            self._register_hooks()

    # ----------------------------------------------------------- hooks
    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    p.register_post_accumulate_grad_hook(
                        self._make_post_hook(p))

    def _make_post_hook(self, p):
        def hook(param):
            self._hook_body(p)
        return hook

    def _hook_body(self, p):
        if p in self._handles and self._handles[p][0] is not None:
            if self._allreduce_delay[p] <= 0:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to step(). "
                    "Increase backward_passes_per_step to accumulate "
                    "gradients locally.")
        assert not p.grad.requires_grad
        assert self._allreduce_delay[p] > 0
        handle, ctx = None, None
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            handle, ctx = self._allreduce_grad_async(p)
        self._handles[p] = (handle, ctx)

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        tensor = p.grad
        # Average semantics with local aggregation: divide by the number of
        # locally accumulated passes so the wire value is the per-pass mean.
        prescale = None
        postscale = None
        if self.op == mpi_ops.Average:
            if self.gradient_predivide_factor != 1.0:
                prescale = 1.0 / self.gradient_predivide_factor
                postscale = self.gradient_predivide_factor / basics.size()
                wire_op = mpi_ops.Sum
            else:
                wire_op = mpi_ops.Average
            # Average semantics only: locally accumulated N passes are
            # divided back to the per-pass mean; Sum/Adasum keep the raw sum.
            if self.backward_passes_per_step > 1:
                prescale = (prescale or 1.0) / self.backward_passes_per_step
        else:
            wire_op = self.op
        # Cast-style compressors (wire_mode attr) ride mpi_ops' wire cast:
        # the result comes back in the gradient's dtype (ctx None →
        # decompress is the identity).  Custom compressors keep the
        # explicit compress/decompress hooks.
        prio = self._priorities.get(p, 0)
        wire = getattr(self._compression, "wire_mode", None)
        if wire is not None:
            handle = mpi_ops.allreduce_async(
                tensor, name=f"allreduce.{name}", op=wire_op,
                prescale_factor=prescale, postscale_factor=postscale,
                process_set=self.process_set, compression=wire,
                priority=prio)
            return handle, None
        tensor_compressed, ctx = self._compression.compress(tensor)
        handle = mpi_ops.allreduce_async(
            tensor_compressed, name=f"allreduce.{name}", op=wire_op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self.process_set, priority=prio)
        return handle, ctx

    # ----------------------------------------------------------- step
    def synchronize(self):
        """Wait for all outstanding gradient allreduces and write the
        averaged gradients back (reference: ``synchronize()``)."""
        if basics.size() <= 1:
            self._synchronized = True
            return
        # Params whose hook never fired this step (e.g. unused branch):
        # submit now so all ranks stay consistent, in parameter order.
        for p in (p for group in self.param_groups for p in group["params"]
                  if p in self._requires_update):
            if p not in self._handles:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in self._handles.items():
            output = mpi_ops.synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
            p.grad.data.copy_(
                self._compression.decompress(output, ctx).reshape(p.grad.shape))
        self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """With this context, ``step()`` will not re-synchronize — used when
        the user called ``synchronize()`` manually (e.g. before gradient
        clipping), matching the reference's API."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                import warnings
                warnings.warn(
                    "optimizer.step() called without a prior backward pass "
                    "re-synchronizing; call optimizer.skip_synchronize() "
                    "around step() if you synchronized manually")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def _find_duplicates(lst):
    seen, dups = set(), set()
    for x in lst:
        if x in seen:
            dups.add(x)
        seen.add(x)
    return dups


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1,
                         op=mpi_ops.Average,
                         gradient_predivide_factor=1.0,
                         process_set: Optional[ProcessSet] = None,
                         check=False):
    """Wrap a torch optimizer so ``step()`` applies globally averaged
    gradients (reference: ``hvd.DistributedOptimizer``).

    Built dynamically as a subclass of the wrapped optimizer's class (the
    reference's pattern), so ``isinstance(opt, torch.optim.SGD)`` holds.

    ``check=`` (the wrap-time lint of the calling script) raises
    ``NotImplementedError`` until the analyzer is ported.
    """
    if check:
        raise NotImplementedError(
            "DistributedOptimizer(check=...) needs the collective analyzer, "
            "which is not ported yet (ROADMAP queue 1, analyzer)")
    if gradient_predivide_factor != 1.0 and op != mpi_ops.Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    if op == mpi_ops.Adasum and gradient_predivide_factor != 1.0:
        raise ValueError(
            "gradient_predivide_factor not supported with Adasum")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set)
