"""The pipeline-parallel slice on the card: one process, the pipelined
Llama at pp = 1 (no mesh: the one stage runs ``pipeline_apply``'s M = 2
microbatches in turn), its stages attending through the flash kernels,
against the same model with the plain attention on the CPU.  Marked
``cuda``; every test skips on a machine without a card.  Run on the card
with ``python -m pytest tests/test_torch_pipeline_parallel_cuda.py -m
cuda`` (this file imports no JAX).

Tolerances: float32, head_dim 64 (the kernels' float32 path): the loss and
every leaf's gradient within 1e-4 relative to the leaf's largest value, as
``tests/test_torch_cuda.py`` holds the kernels.  Launches: a stage runs
its layers once a microbatch, so M × layers forward, dq and dk/dv launches
a step, and with ``remat_stages`` twice the forward (the recomputation).
"""

import pytest
import torch

TOL = 1e-4
LAYERS, MICRO = 2, 2


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


def _run(remat):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tl.tiny(dtype=torch.float32, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=512, max_seq=512, n_layers=LAYERS, pp_axis="pp",
                  n_microbatches=MICRO, remat_stages=remat)
    dev = torch.device("cuda:0")
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 257), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    cpu = {n: t.detach().cpu().requires_grad_()
           for n, t in tl.named_parameters(params)}
    ref_params = {"embed": cpu["embed"], "final_norm": cpu["final_norm"],
                  "lm_head": cpu["lm_head"],
                  "layers": {n.split(".", 1)[1]: t for n, t in cpu.items()
                             if n.startswith("layers.")}}
    ref_loss = tl.loss_fn(ref_params, x.cpu(), y.cpu(), cfg)
    ref_loss.backward()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    loss = tl.loss_fn(params, x, y, cfg)
    loss.backward()
    torch.cuda.synchronize()
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches_dq,
                fa.flash_attention_bwd.launches_dkv)
    grads = {n: t.grad.cpu() for n, t in tl.named_parameters(params)}
    return loss.item(), ref_loss.item(), grads, \
        {n: t.grad for n, t in cpu.items()}, launches


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_torch_pipeline_on_card_matches_plain_attention(card, remat):
    """The pipelined step's loss and every leaf's gradient against the
    plain attention's on the CPU, and the launches a step."""
    loss, ref_loss, grads, ref, launches = _run(remat)
    assert abs(loss - ref_loss) <= TOL * abs(ref_loss)
    for name, g in grads.items():
        assert _rel(g, ref[name]) <= TOL, name
    per_step = MICRO * LAYERS
    assert launches == ((2 if remat else 1) * per_step, per_step, per_step)
