"""The MNIST convnet, Horovod's canonical end-to-end smoke model.

Port of ``horovod_tpu/models/mnist.py:25-134``: two 3×3 ``SAME``
convolutions (stride 1, so symmetric padding) with biases and ReLU, each
followed by a ``VALID`` 2×2 max-pool, then two dense layers.  The
parameters are a plain dictionary in the JAX layout (``HWIO`` convolution
weights, ``[in, out]`` dense weights); :func:`params_from_jax` carries a
JAX tree (as numpy arrays) over unchanged.  Activations are ``NHWC`` in
memory (``channels_last`` views), and the flatten before ``fc1`` walks
``H, W, C`` as the JAX reshape does.

The JAX ``loss_fn`` divides each rank's NLL sum by the global batch and
``psum``s the gradients; here each rank's loss is its own mean and
``hvd.DistributedOptimizer`` averages the gradients, the same gradient
when every rank holds as many images.  :func:`make_sharded_train_step`
(JAX :96-125) takes the global batch through the SPMD harness
(``parallel/spmd.py``); the JAX ``zero_specs`` (a ZeRO-sharded optimizer
state) is here an ``hvd.DistributedOptimizer(..., sharded=True)`` handed
in as ``optimizer``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .llama import named_parameters, params_from_jax  # noqa: F401

__all__ = ["init_params", "params_from_jax", "named_parameters", "forward",
           "loss_fn", "make_train_step", "make_sharded_train_step",
           "synthetic_batch"]


def init_params(generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> Dict:
    """He-normal weights and zero biases from ``generator`` on ``device``
    (the generator's by default), leaves that require grad."""
    device = torch.device(device) if device is not None else \
        generator.device

    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device) \
            * float(np.sqrt(2.0 / fan_in))
        return w.to(dtype).requires_grad_(True)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device,
                           requires_grad=True)

    return {
        "conv1": {"w": he((3, 3, 1, 32), 9), "b": zeros(32)},
        "conv2": {"w": he((3, 3, 32, 64), 9 * 32), "b": zeros(64)},
        "fc1": {"w": he((7 * 7 * 64, 128), 7 * 7 * 64), "b": zeros(128)},
        "fc2": {"w": he((128, 10), 128), "b": zeros(10)},
    }


def _conv(x, p):
    """3×3 ``SAME`` convolution at stride 1 (symmetric padding 1) plus
    bias, on ``x [B, C, H, W]`` with the ``HWIO`` weight."""
    w = p["w"].permute(3, 2, 0, 1).to(memory_format=torch.channels_last)
    return F.conv2d(x, w, p["b"], padding=1)


def forward(params, x):
    """``x [B, 28, 28, 1]`` -> logits ``[B, 10]``."""
    x = x.permute(0, 3, 1, 2)                            # channels_last view
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"])), 2, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"])), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # H, W, C order
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def loss_fn(params, x, y):
    """Mean NLL over this rank's batch, logits in float32."""
    return F.cross_entropy(forward(params, x).float(), y.long())


def make_train_step(optimizer):
    """Returns ``step(params, x, y) -> loss``: zero the grads, forward,
    backward, ``optimizer.step()`` (with ``hvd.DistributedOptimizer``, the
    gradients averaged across processes)."""
    def step(params, x, y):
        optimizer.zero_grad()
        loss = loss_fn(params, x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_sharded_train_step(optimizer, mesh, axis_name: str = "dp"):
    """Returns ``step(params, x, y) -> loss`` over the global batch:
    :func:`make_train_step` fed this rank's block of ``x`` and ``y`` along
    ``axis_name`` of ``mesh`` (JAX :96-125).  With
    ``hvd.DistributedOptimizer(..., sharded=True)`` the optimizer state is
    sharded over the world (the JAX ``zero_specs`` path)."""
    from ..parallel.spmd import make_sharded_train_step as _harness
    return _harness(make_train_step(optimizer), mesh,
                    data_axes=(axis_name,))


def synthetic_batch(batch: int, seed: int = 0) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Deterministic fake digits, the JAX ``synthetic_batch``:
    class-dependent blobs plus noise, ``([B, 28, 28, 1] float32, [B]
    int32)``."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=(batch,)).astype(np.int32)
    x = rng.randn(batch, 28, 28, 1).astype(np.float32) * 0.1
    for i, cls in enumerate(y):
        r, c = divmod(int(cls), 4)
        x[i, 4 + r * 6:10 + r * 6, 4 + c * 6:10 + c * 6, 0] += 1.0
    return x, y
