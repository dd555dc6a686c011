"""The expert-parallel slice on the card: a MoE Llama training step and a
DLRM step, each against the same step on the CPU.  Marked ``cuda``; every
test skips on a machine without a card.  Run on the card with
``python -m pytest tests/test_torch_expert_cuda.py -m cuda`` (this file
imports no JAX).

Tolerances: float32 throughout.  The MoE step's attention runs the flash
kernels on the card and their plain versions on the CPU (other summation
orders: 1e-4 relative to each leaf's largest gradient, as
``tests/test_torch_cuda.py`` holds the kernels); the routing is the same
(the router's logits are float32 on both, and no two probabilities of
these inputs are within the difference).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import dlrm, llama as tl
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import expert

TOL = 1e-4


@pytest.fixture()
def cuda_device():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(a, b):
    return (a.float().cpu() - b.float().cpu()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


def _moe_step(cfg, params, tokens, targets):
    named = list(tl.named_parameters(params))
    rep, sh = expert.split_named(named, tl.param_specs(cfg))
    opt = torch.optim.SGD([t for _, t in rep], lr=0.1)
    eps = expert.ExpertParallel(None, torch.optim.SGD([t for _, t in sh],
                                                      lr=0.1))
    opt.zero_grad()
    eps.zero_grad()
    loss = tl.loss_fn(params, tokens, targets, cfg)
    loss.backward()
    grads = {n: t.grad.detach().clone() for n, t in named}
    opt.step()
    eps.step()
    return loss.item(), grads, {n: t.detach() for n, t in named}


@pytest.mark.cuda
def test_torch_moe_llama_step_on_card_matches_cpu(cuda_device):
    """Gated top-2 experts with the router losses, 2 layers, head_dim 64,
    T = 256: the loss, every gradient and the stepped parameters against
    the CPU; one flash forward, dq and dk/dv launch a layer."""
    cfg = tl.tiny(dtype=torch.float32, d_model=128, n_heads=2,
                  n_kv_heads=1, n_experts=4, router_top_k=2, moe_gated=True,
                  capacity_factor=4.0, ep_axis="ep", router_z_weight=1e-3,
                  max_seq=256)
    cpu = tl.init_params(cfg, torch.Generator().manual_seed(0))
    card = _unflatten({n: t.detach() for n, t in tl.named_parameters(cpu)},
                      cpu, cuda_device)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    y = torch.from_numpy(rng.randint(0, 256, (2, 256)))
    want = _moe_step(cfg, cpu, x, y)
    tfa.flash_attention_fwd.launches = 0
    tfa.flash_attention_bwd.launches_dq = 0
    tfa.flash_attention_bwd.launches_dkv = 0
    got = _moe_step(cfg, card, x.to(cuda_device), y.to(cuda_device))
    torch.cuda.synchronize()
    assert [tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv] == [cfg.n_layers] * 3
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    for name, g in want[1].items():
        assert _rel(got[1][name], g) <= TOL, name
        assert _rel(got[2][name], want[2][name]) <= TOL, name


def _unflatten(flat, like, device):
    """``like``'s tree with the leaves of the dotted-name dict ``flat``
    (the parameters copied to the card), leaves that require grad."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        return flat[".".join(path)].detach().clone().to(device
                                                    ).requires_grad_(True)
    return walk(like, ())


@pytest.mark.cuda
def test_torch_dlrm_step_on_card_matches_cpu(cuda_device):
    """A DLRM SGD step at ep off on the card: the loss, the gradients and
    the stepped parameters against the CPU."""
    cfg = dlrm.tiny(dp_axis=None)
    cpu = dlrm.init_params(cfg, torch.Generator().manual_seed(0))
    named_cpu = dict(tl.named_parameters(cpu))
    card = _unflatten({n: t.detach() for n, t in named_cpu.items()}, cpu,
                      cuda_device)
    batch = [torch.from_numpy(a) for a in dlrm.synthetic_batch(cfg, 64)]
    out = {}
    for where, params, dev in (("cpu", cpu, "cpu"),
                               ("card", card, cuda_device)):
        named = list(tl.named_parameters(params))
        rep, sh = expert.split_named(named, dlrm.param_specs(cfg))
        eps = expert.ExpertParallel(None, torch.optim.SGD(
            [t for _, t in sh], lr=0.1))
        step = dlrm.make_train_step(
            cfg, torch.optim.SGD([t for _, t in rep], lr=0.1), experts=eps)
        loss = step(params, *(a.to(dev) for a in batch)).item()
        out[where] = (loss, {n: t.detach() for n, t in named})
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=TOL)
    for name, t in out["cpu"][1].items():
        assert _rel(out["card"][1][name], t) <= TOL, name
