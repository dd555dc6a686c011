"""The analyzer on the card: the sanitizer's content hash of a bfloat16
CUDA tensor, its tag on a CUDA submission through the engine, and the
collective audit of a tp Llama step's loss and gradients on CUDA
parameters, which launches no kernel.  Marked ``cuda``; every test skips
on a machine without a card.  Run on the card with ``python -m pytest
tests/test_torch_analysis_cuda.py -m cuda`` (this file imports no JAX).
"""

import pytest
import torch

from horovod_tpu_torch.analysis import runtime_sanitizer as rs
from horovod_tpu_torch.analysis import trace_check as tc
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import mesh as tmesh


@pytest.fixture()
def cuda_device():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


class _Entry:
    def __init__(self, t):
        self.tensor = t


@pytest.mark.cuda
def test_cuda_bf16_content_hash_equals_its_cpu_copy(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    t = torch.randn(257, 33, device=cuda_device, generator=g).to(
        torch.bfloat16)
    h = rs.CollectiveSanitizer._content_hash(_Entry(t))
    assert h is not None and len(h) == 16
    assert h == rs.CollectiveSanitizer._content_hash(_Entry(t.cpu()))
    assert h != rs.CollectiveSanitizer._content_hash(_Entry(t + 1))


@pytest.mark.cuda
def test_cuda_sanitizer_tags_a_cuda_submission(cuda_device, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.shutdown()
    monkeypatch.setenv("HVD_TPU_SANITIZER", "hash")
    hvd.init()
    try:
        eng = basics._get_state().engine
        t = torch.ones(8, dtype=torch.bfloat16, device=cuda_device)
        out = hvd.allreduce(t, name="cuda.t", op=hvd.Sum)
        assert out.device.type == "cuda"
        rec = eng.sanitizer.ledger[-1]
        assert (rec.name, rec.digest) == \
            ("cuda.t", "allreduce|bfloat16|(8,)|SUM")
        assert rec.site.startswith("test_torch_analysis_cuda.py:")
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_cuda_audit_launches_nothing(cuda_device):
    cfg = tl.tiny(dtype=torch.bfloat16)
    mesh = tc.AbstractMesh({"tp": 2})
    params = tl.shard_params(
        tl.init_params(cfg, torch.Generator().manual_seed(0)), cfg, mesh)
    params = _to(params, cuda_device)
    for _, t in tl.named_parameters(params):
        t.requires_grad_(True)
    step = tl.make_train_step(
        cfg, torch.optim.SGD([t for _, t in tl.named_parameters(params)],
                             lr=0.1), mesh)
    tokens = torch.randint(0, 256, (1, 64), device=cuda_device)
    torch.cuda.synchronize()
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    rep = tc.check_step_fn(step.audit, params, tokens, tokens, mesh=mesh)
    torch.cuda.synchronize()
    assert rep.ok, rep.findings
    assert len(rep.ledger) == 4 * cfg.n_layers
    assert rep.ledger[0].dtypes == ("bfloat16",)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == before
    assert tmesh._audit is None
    assert all(t.grad is None for _, t in tl.named_parameters(params))
