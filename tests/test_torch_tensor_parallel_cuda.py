"""The tensor-parallel slice on the card: two ranks on ``make_mesh({"tp":
2})`` over NCCL, started through the port's launcher (one ``-H`` entry a
rank on one card, as ``chip_smoke.py`` starts its ranks; ``-H
localhost:2`` with two cards), each against the tp-off model on its own
rank.  Marked ``cuda``; every test skips on a machine without a card.  Run
on the card with ``python -m pytest tests/test_torch_tensor_parallel_cuda.py
-m cuda`` (this file imports no JAX).

Tolerances: float32 throughout, head_dim 64 (the flash kernels' float32
path on both sides, other summation orders over the tp sum): gradients and
logits within 1e-4 relative to each leaf's largest value, as
``tests/test_torch_cuda.py`` holds the kernels; greedy tokens equal.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4

_WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    mesh = parallel.make_mesh({"tp": 2})
    cfg = tl.tiny(dtype=torch.float32, d_model=256, n_heads=4,
                  n_kv_heads=2, d_ff=512, max_seq=512)
    specs = tl.param_specs(cfg)
    full = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    ref_loss = tl.loss_fn(full, x, y, cfg)
    ref_loss.backward()
    ref = {}
    for name, t in tl.named_parameters(full):
        s = parallel.split_of(parallel.spec_of(specs)[name])
        g = t.grad
        if s is not None:
            g = parallel.shard_tree(g, s, r, 2, "tp")
        ref[name] = g.cpu()
        t.grad = None
    params = tl.shard_params(full, cfg, mesh)
    named = list(tl.named_parameters(params))
    rep, sh = parallel.split_named(named, specs, ("tp",))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in rep], lr=0.1), named_parameters=rep)
    shards = parallel.ShardedParallel(
        mesh, torch.optim.SGD([t for _, t in sh], lr=0.1), sh, specs)
    fa.flash_attention_fwd.launches = 0
    opt.zero_grad()
    loss = tl.loss_fn(params, x, y, cfg, mesh)
    loss.backward()
    opt.synchronize()
    shards.sync_grads()
    grads = {n: t.grad.cpu() for n, t in named}
    launches = fa.flash_attention_fwd.launches
    with torch.no_grad():
        prompt = toks[:, :64]
        gen = tl.generate(params, prompt, 4, cfg, mesh=mesh)
        gen0 = tl.generate(full, prompt, 4, cfg)
        logits, _ = tl.prefill(params, tl.init_cache(cfg, 2, 64, dev,
                                                     mesh=mesh), prompt,
                               cfg, mesh)
        logits0, _ = tl.prefill(full, tl.init_cache(cfg, 2, 64, dev),
                                prompt, cfg)
    out = dict(loss=loss.item(), ref_loss=ref_loss.item(), grads=grads,
               ref=ref, launches=launches, gen=gen.cpu(), gen0=gen0.cpu(),
               logits=logits.cpu(), logits0=logits0.cpu())
    shards.shutdown()
    mesh.shutdown()
    hvd.shutdown()
    with open(sys.argv[2] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("TP_CUDA_OK", r)
""")


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    """Both ranks' results; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    tmp = tmp_path_factory.mktemp("tp_cuda")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    hosts = ("localhost:2" if torch.cuda.device_count() >= 2
             else "localhost:1,127.0.0.1:1")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2", "-H",
         hosts, sys.executable, str(script), REPO, str(tmp / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.count("TP_CUDA_OK") == 2, (
        res.stdout[-4000:] + res.stderr[-4000:])
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(
        b.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_torch_tp_step_on_card_matches_tp_off(tp_ranks):
    """A tp = 2 step's loss (bitwise across the ranks) and every leaf's
    gradient (after the world average and ``ShardedParallel``) against
    the matching block of the tp-off model's, one flash forward a layer."""
    a, b = tp_ranks
    assert a["loss"] == b["loss"]
    for o in tp_ranks:
        assert abs(o["loss"] - o["ref_loss"]) <= TOL * abs(o["ref_loss"])
        assert o["launches"] == 2
        for name, g in o["grads"].items():
            assert _rel(g, o["ref"][name]) <= TOL, name


@pytest.mark.cuda
def test_torch_tp_decode_on_card_matches_tp_off(tp_ranks):
    """tp = 2 prefill logits within TOL of tp-off's, and greedy tokens
    equal to tp-off's on both ranks."""
    for o in tp_ranks:
        assert _rel(o["logits"], o["logits0"]) <= TOL
        assert torch.equal(o["gen"], o["gen0"])
    assert torch.equal(tp_ranks[0]["gen"], tp_ranks[1]["gen"])
