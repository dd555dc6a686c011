"""The port's trace check (``horovod_tpu_torch/analysis/trace_check.py``, a
``torch.fx`` walk) held against the JAX package's jaxpr walk on the CPU.

- The same tiny tp Llama forward (seeded numpy weights): JAX under
  ``shard_map`` on 8 virtual CPU devices as dp 4 × tp 2, the port on an
  ``AbstractMesh`` of those sizes (``axis_sizes=``, no world) with this
  rank's tp block of the same weights.  The two ledgers are equal
  (``compare_ledgers == []``): one ``psum`` over tp of ``[B/4, T, D]``
  float32 after each row-split product.
- Planted faults give the JAX rule IDs: a collective over an axis nothing
  binds (HVD201), a host sync inside the step (HVD203; ``.item()`` in the
  port, ``pure_callback`` in JAX), a collective over a bound axis the
  specs never split over (HVD112).
- The port's ring attention and pipeline (``send_recv``'s one-sided hops
  recorded as the rotation) give no HVD204, as the JAX ring and pipeline
  do (``tests/test_analysis.py::test_repo_ring_and_pipeline_perms_are_
  bijective``).
- The audit executes nothing: no collective moves (the mesh's hook is
  disarmed after it), and the loss-and-gradients audit of a Llama step
  counts the backward's sums too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.analysis import trace_check as jtc
from horovod_tpu.compat import shard_map
from horovod_tpu.models import llama as jl
from horovod_tpu_torch.analysis import trace_check as tc
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel.mesh import psum

SIZES = {"dp": 4, "tp": 2}
B, T = 8, 16


def _rules(report):
    return sorted({f.rule for f in report.findings})


@pytest.fixture(scope="module")
def weights():
    cfg = jl.tiny(dtype=jnp.float32, dp_axis="dp", tp_axis="tp",
                  sp_axis=None, use_flash=False)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(cfg, jax.random.PRNGKey(3)))
    tokens = np.random.RandomState(4).randint(0, 256, (B, T)).astype(
        np.int32)
    return cfg, params, tokens


def _jax_forward_report(cfg, params, tokens):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    step = shard_map(lambda p, t: jl.forward(p, t, cfg), mesh=mesh,
                     in_specs=(jl.param_specs(cfg), P("dp")),
                     out_specs=P("dp"), check_vma=False)
    return jtc.check_step_fn(step, params, jnp.asarray(tokens), mesh=mesh)


def _port_block(params):
    cfg = tl.tiny(dtype=torch.float32)
    mesh = tc.AbstractMesh(SIZES)
    block = tl.shard_params(tl.params_from_jax(params), cfg, mesh)
    return cfg, mesh, block


def test_torch_tp_llama_forward_ledger_equals_jax(weights):
    jcfg, params, tokens = weights
    jrep = _jax_forward_report(jcfg, params, tokens)
    cfg, mesh, block = _port_block(params)
    local = torch.from_numpy(tokens[:B // 4].astype(np.int64))
    rep = tc.check_step_fn(lambda p, t: tl.forward(p, t, cfg, mesh), block,
                           local, axis_sizes=SIZES)
    assert jrep.ok and rep.ok, (jrep.findings, rep.findings)
    assert len(rep.ledger) == 2 * cfg.n_layers
    assert rep.ledger[0].digest() == \
        "psum|tp|((2, 16, 64),)|('float32',)|None"
    assert tc.compare_ledgers(rep.ledger, jrep.ledger) == []
    assert jtc.compare_ledgers(jrep.ledger, rep.ledger) == []
    assert rep.bound_axes == SIZES


def test_torch_planted_faults_give_the_jax_rules():
    mesh = tc.AbstractMesh({"tp": 2})

    def unbound(x):
        return psum(x, mesh, "tq")

    def host_sync(x):
        y = psum(x, mesh, "tp")
        return y * y.sum().item()

    def undeclared(x):
        return psum(x, mesh, "tp")

    x = torch.zeros(4)
    port = [
        tc.check_step_fn(unbound, x, axis_sizes={"tp": 2}),
        tc.check_step_fn(host_sync, x, axis_sizes={"tp": 2}),
        tc.check_step_fn(undeclared, x, axis_sizes={"tp": 2, "dp": 4},
                         partition_axes=["dp"]),
    ]
    jx = jnp.zeros((4,))
    jax_reports = [
        jtc.check_step_fn(lambda v: jax.lax.psum(v, "tq"), jx,
                          axis_sizes={"tp": 2}),
        jtc.check_step_fn(lambda v: jax.pure_callback(
            lambda a: a, jax.ShapeDtypeStruct(v.shape, v.dtype),
            jax.lax.psum(v, "tp")), jx, axis_sizes={"tp": 2}),
        jtc.check_step_fn(lambda v: jax.lax.psum(v, "tp"), jx,
                          axis_sizes={"tp": 2, "dp": 4},
                          partition_axes=["dp"]),
    ]
    assert [_rules(r) for r in port] == [_rules(r) for r in jax_reports] \
        == [["HVD201"], ["HVD203"], ["HVD112"]]
    assert not port[0].ok and port[1].ok and not port[2].ok
    sync = port[1].findings[0]
    assert "'item'" in sync.message and sync.line == 1


def test_torch_ring_and_pipeline_perms_are_bijective():
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    sp = tc.AbstractMesh({"sp": 4})
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    kv = torch.zeros(1, 8, 1, 64, requires_grad=True)

    def ring(q, k, v):
        o = ring_attention(q, k, v, sp, "sp", causal=True)
        return torch.autograd.grad(o.sum(), [q, k, v])

    rep = tc.check_step_fn(ring, q, kv, kv, mesh=sp)
    assert rep.ok and "HVD204" not in _rules(rep), rep.findings
    assert {r.primitive for r in rep.ledger} == {"ppermute"}
    assert len(rep.ledger) >= 6     # forward and backward rotations

    for coord in (0, 3):
        pp = tc.AbstractMesh({"pp": 4}, coords={"pp": coord})
        w = torch.ones(3, requires_grad=True)

        def pipe(w, xs):
            out = pipeline_apply(lambda p, x: x * p, w, xs, pp, "pp")
            return torch.autograd.grad(out.sum(), [w])

        rep = tc.check_step_fn(pipe, w, torch.ones(4, 2, 3), mesh=pp)
        assert rep.ok and "HVD204" not in _rules(rep), rep.findings
        assert rep.ledger and all(r.primitive == "ppermute"
                                  for r in rep.ledger)

    # The JAX ring and pipeline lint clean under HVD204 too.
    from horovod_tpu.parallel.pipeline import pipeline_apply as jpipe
    mesh = Mesh(np.array(jax.devices()[:4]), ("pp",))
    step = shard_map(lambda xs: jpipe(lambda p, x: x * 2.0, jnp.zeros(()),
                                      xs, axis_name="pp"),
                     mesh=mesh, in_specs=P(None, "pp"),
                     out_specs=P(None, "pp"), check_vma=False)
    jrep = jtc.check_step_fn(step, jnp.zeros((4, 4, 2)), mesh=mesh)
    assert "HVD204" not in _rules(jrep)


def test_torch_compare_ledgers_names_the_first_divergence():
    mesh = tc.AbstractMesh({"dp": 8})

    def a(x):
        return tmesh.all_gather(psum(x, mesh, "dp"), mesh, "dp")

    def b(x):
        return psum(tmesh.all_gather(x, mesh, "dp"), mesh, "dp")

    x = torch.zeros(4)
    la = tc.check_step_fn(a, x, mesh=mesh).ledger
    lb = tc.check_step_fn(b, x, mesh=mesh).ledger
    assert tc.compare_ledgers(la, la) == []
    diff = tc.compare_ledgers(la, lb, names=("rank 0", "rank 1"))
    assert diff and diff[0].rule == "HVD301" and "#0" in diff[0].message
    short = tc.compare_ledgers(la[:1], la)
    assert short and "block forever" in short[0].message


def test_torch_audit_moves_nothing_and_counts_the_backward(weights):
    """The audit of a tp Llama step's loss and gradients on a real world of
    one (no process group: a collective would raise): 2 sums a layer
    forward (``ReduceOutput``) and 2 backward (``CopyInput``), the hook
    disarmed after it, and no parameter touched."""
    _, params, tokens = weights
    cfg, mesh, block = _port_block(params)
    for _, t in tl.named_parameters(block):
        t.requires_grad_(True)
    before = {k: v.detach().clone() for k, v in tl.named_parameters(block)}
    opt = torch.optim.SGD([t for _, t in tl.named_parameters(block)], lr=1.0)
    step = tl.make_train_step(cfg, opt, mesh)
    local = torch.from_numpy(tokens[:2].astype(np.int64))
    rep = tc.check_step_fn(step.audit, block, local, local, mesh=mesh)
    assert rep.ok, rep.findings
    assert len(rep.ledger) == 4 * cfg.n_layers
    assert tmesh._audit is None
    assert all(torch.equal(v, before[k])
               for k, v in tl.named_parameters(block))
    assert all(t.grad is None for _, t in tl.named_parameters(block))
