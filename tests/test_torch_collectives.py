"""Allgather, alltoall, reducescatter, join and SyncBatchNorm through the
port's engine, against the JAX engine on the same seeded inputs.

A two-process gloo world (the pattern of ``tests/test_torch_dtypes.py``)
runs every collective once through the port's public API; each test then
feeds the same inputs to the JAX engine in this process (a process set of
two on its CPU mesh) and compares.  Integer and byte results must be
bitwise equal; float32 ones too, as these collectives move bytes or add
two values once, except SyncBatchNorm, held to 1e-5 against
``torch.nn.BatchNorm2d`` over the global batch.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.net import reserve_ports
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import engine as port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("Sum", "Average", "Min", "Max", "Product")
DTYPES = ("float32", "int32")


def _x(rank, shape, dtype, salt=0):
    """Rank ``rank``'s seeded input: small integers (exact products and
    sums), as float32 or int32."""
    rng = np.random.RandomState(1000 + 31 * rank + salt)
    return rng.randint(-4, 5, shape).astype(dtype)


def _splits(rank):
    return np.random.RandomState(77 + rank).randint(0, 4, 2).tolist()


def _inputs(rank):
    return {
        "ag": _x(rank, (3, 4), "float32"),
        "ag_int": _x(rank, (2, 5), "int32", 1),
        "gag": [_x(rank, (2, 3), "float32", 2), _x(rank, (4,), "int32", 3),
                _x(rank, (1, 2, 2), "float32", 4)],
        "obj": {"rank": rank, "items": list(range(rank + 2)), "s": "x" * 9},
        "a2a": _x(rank, (4, 3), "float32", 5),
        "a2a_int": _x(rank, (6,), "int32", 6),
        "ragged": _x(rank, (sum(_splits(rank)), 3), "float32", 7),
        "rs": {(op, dt): _x(rank, (4, 3), dt, 8) for op in OPS
               for dt in DTYPES},
        "rs_odd": _x(rank, (3, 2), "int32", 9),
        "join": {(op, dt): _x(rank, (5,), dt, 10) for op in OPS
                 for dt in DTYPES},
        "bn": np.random.RandomState(500 + rank).randn(4, 3, 5, 5)
                .astype(np.float32),
        "bn_grad": np.random.RandomState(600 + rank).randn(4, 3, 5, 5)
                     .astype(np.float32),
    }


_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.controller import NegotiationError
    hvd.init(device="cpu")
    r = hvd.rank()
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)[r]
    T = torch.from_numpy
    out = {}
    out["ag"] = hvd.allgather(T(ins["ag"])).numpy()
    out["ag_int"] = hvd.allgather(T(ins["ag_int"]), name="agi").numpy()
    out["gag"] = [t.numpy() for t in hvd.grouped_allgather(
        [T(a) for a in ins["gag"]])]
    out["obj"] = hvd.allgather_object(ins["obj"])
    out["a2a"] = hvd.alltoall(T(ins["a2a"])).numpy()
    out["a2a_int"] = hvd.alltoall(T(ins["a2a_int"])).numpy()
    o, rs = hvd.alltoall(T(ins["ragged"]), splits=ins["splits"])
    out["ragged"] = (o.numpy(), rs.numpy())
    for (op, dt), x in ins["rs"].items():
        res = hvd.reducescatter(T(x), op=getattr(hvd, op),
                                name=f"rs.{op}.{dt}")
        out[("rs", op, dt)] = (str(res.dtype)[6:], res.numpy())
    res = hvd.reducescatter(T(ins["rs_odd"]), op=hvd.Min)
    out["rs_odd"] = res.numpy()
    try:
        hvd.reducescatter(T(ins["rs_odd"]), op=hvd.Sum)
        out["rs_odd_sum"] = "returned"
    except ValueError as exc:
        out["rs_odd_sum"] = str(exc)
    try:
        hvd.allgather(torch.zeros(2 + r, 3), name="ragged_first_dim")
        out["ag_mismatch"] = "returned"
    except NegotiationError as exc:
        out["ag_mismatch"] = str(exc)
    # SyncBatchNorm: forward and backward over the two ranks' batches.
    bn = hvd.SyncBatchNorm(3, momentum=0.5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, -0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.2, -0.3]))
    x = T(ins["bn"]).requires_grad_()
    y = bn(x)
    y.backward(T(ins["bn_grad"]))
    out["bn"] = (y.detach().numpy(), x.grad.numpy(),
                 bn.running_mean.numpy(), bn.running_var.numpy(),
                 bn.weight.grad.numpy(), bn.bias.grad.numpy())
    # Join: rank 1 joins at once; rank 0's reductions see its identity.
    if r == 0:
        for (op, dt), x in ins["join"].items():
            out[("join", op, dt)] = hvd.allreduce(
                T(x), op=getattr(hvd, op), name=f"j.{op}.{dt}").numpy()
    out["last_joined"] = hvd.join()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("COLLECTIVES_OK", r)
""")


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    ins = [dict(_inputs(r), splits=_splits(r)) for r in range(2)]
    with open(tmp / "ins.pkl", "wb") as fh:
        pickle.dump(ins, fh)
    script = tmp / "collectives.py"
    script.write_text(_WORKER)
    with reserve_ports(2) as held:
        port, port2 = held.ports
        procs = []
        for r in range(2):
            env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                       HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                       HOROVOD_CONTROLLER_PORT=str(port),
                       HOROVOD_CONTROLLER_PORT2=str(port2))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), REPO, str(tmp / "ins.pkl"),
                 str(tmp / "out")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=120)[0])
            finally:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"COLLECTIVES_OK {r}" in log, log
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture()
def jax_ps(hvd):
    ps = hvd.add_process_set([0, 1])
    yield ps
    hvd.remove_process_set(ps)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                       b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


# ------------------------------------------------------------------ allgather
@pytest.mark.parametrize("key", ["ag", "ag_int"])
def test_torch_allgather_matches_jax_engine(hvd, jax_ps, gloo_world, key):
    ins = [_inputs(r)[key] for r in range(2)]
    ref = np.asarray(hvd.allgather(hvd.stack_per_rank(ins, jax_ps),
                                   process_set=jax_ps))
    for r in range(2):
        _same(gloo_world[r][key], ref)


def test_torch_grouped_allgather_matches_jax_engine(hvd, jax_ps, gloo_world):
    ins = [_inputs(r)["gag"] for r in range(2)]
    refs = hvd.grouped_allgather(
        [hvd.stack_per_rank([ins[0][i], ins[1][i]], jax_ps)
         for i in range(3)], process_set=jax_ps)
    for r in range(2):
        for got, ref in zip(gloo_world[r]["gag"], refs):
            _same(got, np.asarray(ref))


def test_torch_allgather_object_matches_jax_engine(hvd, jax_ps, gloo_world):
    objs = [_inputs(r)["obj"] for r in range(2)]
    ref = hvd.allgather_object(objs, process_set=jax_ps, per_rank=True)
    assert gloo_world[0]["obj"] == gloo_world[1]["obj"] == ref == objs


def test_torch_allgather_first_dims_that_differ_fail_negotiation(
        gloo_world):
    """Per-rank shapes are part of the negotiation digest in both engines
    (the JAX one announces the shape of its ``[1, *S]`` shard without the
    leading 1), so an allgather whose first dims differ across ranks is
    refused on every rank with the coordinator's mismatch verdict."""
    from horovod_tpu.common.controller import TCPController as JaxCtl
    from horovod_tpu_torch.common.controller import TCPController as PortCtl
    for r in range(2):
        assert "mismatched submissions" in gloo_world[r]["ag_mismatch"]

    class E:
        ctype = port_engine.CollectiveType.ALLGATHER
        reduce_op = C.ReduceOp.AVERAGE

    digests = []
    for rows in (2, 3):
        jax_e, port_e = E(), E()
        jax_e.tensor = np.zeros((1, rows, 3), np.float32)
        port_e.tensor = torch.zeros(rows, 3)
        assert JaxCtl._digest(jax_e) == PortCtl._digest(port_e)
        digests.append(PortCtl._digest(port_e))
    assert digests[0] != digests[1]


# ------------------------------------------------------------------- alltoall
@pytest.mark.parametrize("key", ["a2a", "a2a_int"])
def test_torch_alltoall_matches_jax_engine(hvd, jax_ps, gloo_world, key):
    ins = [_inputs(r)[key] for r in range(2)]
    ref = np.asarray(hvd.alltoall(hvd.stack_per_rank(ins, jax_ps),
                                  process_set=jax_ps))
    for r in range(2):
        _same(gloo_world[r][key], ref[r])


def test_torch_ragged_alltoall_matches_jax_engine(hvd, jax_ps, gloo_world):
    ins = [_inputs(r)["ragged"] for r in range(2)]
    outs, rsplits = hvd.alltoall(ins, splits=[_splits(r) for r in range(2)],
                                 process_set=jax_ps)
    for r in range(2):
        got, got_splits = gloo_world[r]["ragged"]
        _same(got, outs[r])
        assert got_splits.tolist() == np.asarray(rsplits[r]).tolist()


# -------------------------------------------------------------- reducescatter
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_torch_reducescatter_matches_jax_engine(hvd, jax_ps, gloo_world, op,
                                                dt):
    """Average divides with ``/`` in both: an int32 input returns
    float32."""
    ins = [_inputs(r)["rs"][(op, dt)] for r in range(2)]
    ref = np.asarray(hvd.reducescatter(hvd.stack_per_rank(ins, jax_ps),
                                       op=getattr(hvd, op),
                                       process_set=jax_ps))
    want = "float32" if op == "Average" else dt
    for r in range(2):
        got_dt, got = gloo_world[r][("rs", op, dt)]
        assert got_dt == want
        _same(got, ref[r])


def test_torch_reducescatter_of_a_dim_that_does_not_divide(hvd, jax_ps,
                                                           gloo_world):
    """Three rows over two ranks: Min keeps one row each and drops the
    third, as the JAX program's slice does; Sum is refused in both (the
    JAX one when its program is traced, the port's at submission)."""
    ins = [_inputs(r)["rs_odd"] for r in range(2)]
    ref = np.asarray(hvd.reducescatter(hvd.stack_per_rank(ins, jax_ps),
                                       op=hvd.Min, process_set=jax_ps))
    for r in range(2):
        _same(gloo_world[r]["rs_odd"], ref[r])
        assert "divisible" in gloo_world[r]["rs_odd_sum"]
    with pytest.raises(ValueError, match="divisible"):
        hvd.reducescatter(hvd.stack_per_rank(ins, jax_ps), op=hvd.Sum,
                          process_set=jax_ps)


# ------------------------------------------------------------------------ join
_FILL_DTYPES = [("float32", torch.float32, np.float32),
                ("int32", torch.int32, np.int32),
                ("bfloat16", torch.bfloat16, "bfloat16"),
                ("int8", torch.int8, np.int8),
                ("uint8", torch.uint8, np.uint8),
                ("bool", torch.bool, np.bool_)]


@pytest.mark.parametrize("ctype", ["ALLREDUCE", "REDUCESCATTER", "ALLGATHER",
                                   "BROADCAST", "ALLTOALL"])
@pytest.mark.parametrize("name,tdt,ndt", _FILL_DTYPES,
                         ids=[d[0] for d in _FILL_DTYPES])
def test_torch_join_fill_value_matches_jax_engine(name, tdt, ndt, ctype):
    import ml_dtypes
    from horovod_tpu.ops.engine import CollectiveEngine as JaxEngine
    from horovod_tpu.ops.engine import CollectiveType as JaxCType
    from horovod_tpu.ops.collectives import ReduceOp as JaxOp
    nd = ml_dtypes.bfloat16 if ndt == "bfloat16" else np.dtype(ndt)
    for op in C.ReduceOp:
        got = port_engine._join_fill_value(
            port_engine.CollectiveType[ctype], op, tdt)
        ref = JaxEngine._join_fill_value(JaxCType[ctype], JaxOp[op.name], nd)
        assert float(got) == float(ref), (op, got, ref)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_torch_join_reduces_with_the_fill_value(gloo_world, op, dt):
    """Rank 1 joined before rank 0's allreduces: rank 0's result is its own
    tensor reduced with the JAX engine's fill value, and join returns the
    last rank to join on both ranks."""
    from horovod_tpu.ops.engine import CollectiveEngine as JaxEngine
    from horovod_tpu.ops.engine import CollectiveType as JaxCType
    from horovod_tpu.ops.collectives import ReduceOp as JaxOp
    x0 = _inputs(0)["join"][(op, dt)]
    fill = np.full_like(x0, JaxEngine._join_fill_value(
        JaxCType.ALLREDUCE, JaxOp[op.upper()], np.dtype(dt)))
    both = np.stack([x0, fill])
    if op == "Average":
        ref = both.sum(0) / 2 if dt == "float32" else both.sum(0) // 2
    else:
        ref = getattr(both, {"Sum": "sum", "Min": "min", "Max": "max",
                             "Product": "prod"}[op])(0)
    _same(gloo_world[0][("join", op, dt)], ref.astype(dt))
    assert gloo_world[0]["last_joined"] == gloo_world[1]["last_joined"] == 0


# -------------------------------------------------------------- SyncBatchNorm
def test_torch_sync_batch_norm_is_global_batch_norm(gloo_world):
    """Two ranks' SyncBatchNorm against ``torch.nn.BatchNorm2d`` on the
    concatenated batch: outputs, input gradients and running statistics;
    the affine gradients stay per rank (the optimizer averages them)."""
    ins = [_inputs(r) for r in range(2)]
    bn = torch.nn.BatchNorm2d(3, momentum=0.5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, -0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.2, -0.3]))
    x = torch.from_numpy(np.concatenate([i["bn"] for i in ins])) \
        .requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(np.concatenate([i["bn_grad"] for i in ins])))
    mean = x.detach().mean((0, 2, 3), keepdim=True)
    var = x.detach().var((0, 2, 3), unbiased=False, keepdim=True)
    for r in range(2):
        out, gx, rmean, rvar, gw, gb = gloo_world[r]["bn"]
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(out, y.detach().numpy()[rows], atol=1e-5)
        np.testing.assert_allclose(gx, x.grad.numpy()[rows], atol=1e-5)
        np.testing.assert_allclose(rmean, bn.running_mean.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(rvar, bn.running_var.numpy(), atol=1e-5)
        xhat = ((x.detach()[rows] - mean) / torch.sqrt(var + bn.eps)).numpy()
        np.testing.assert_allclose(
            gw, (ins[r]["bn_grad"] * xhat).sum((0, 2, 3)), rtol=1e-5,
            atol=1e-4)
        np.testing.assert_allclose(gb, ins[r]["bn_grad"].sum((0, 2, 3)),
                                   rtol=1e-5, atol=1e-4)


def test_torch_sync_batch_norm_at_size_one_matches_jax_binding(hvd):
    """At size one the port's SyncBatchNorm is batch norm over its own
    batch.  The JAX binding's runs in a process that holds the whole
    8-rank world, so it is given a process set of one rank: its fused
    allreduce of the statistics then sees this batch alone."""
    import horovod_tpu.torch as jhvd
    import horovod_tpu_torch as phvd
    x = torch.from_numpy(_inputs(0)["bn"])
    g = torch.from_numpy(_inputs(0)["bn_grad"])
    one = hvd.add_process_set([0])
    outs = []
    try:
        for bn in (jhvd.SyncBatchNorm(3, momentum=0.5, process_set=one),
                   phvd.SyncBatchNorm(3, momentum=0.5)):
            xi = x.clone().requires_grad_()
            y = bn(xi)
            y.backward(g)
            outs.append((y.detach(), xi.grad, bn.running_mean.clone(),
                         bn.running_var.clone()))
    finally:
        hvd.remove_process_set(one)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
