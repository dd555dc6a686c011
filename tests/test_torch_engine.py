"""The port's collective engine against the JAX package's.

- Batching: the port's ``_compute_response_list`` cuts the same batches, by
  name, as the JAX engine's for the same entries (mixed dtypes, groups,
  priorities, tensors either side of the 64 MB fusion threshold, which
  both count in global stacked bytes).
- Arithmetic: the plain pack and unpack (``ops/fusion.py``, what the CPU
  path runs and what the CUDA kernels are held to on the card), around a
  reduction over three ranks' buffers, against the JAX fused program
  (``_build_fused_reduce`` through ``hvd.allreduce`` over a three-rank
  process set of the 8-device CPU mesh): prescale, postscale, wire bf16,
  ``Average`` and integer floor division.  Bitwise: the inputs are small
  integers (halves after a prescale of 0.5), so the sums are exact in every
  dtype and each rounding the two programs make is one they make at the
  same place.
- The two faults the engine slice repaired, each on its input, and the
  in-flight abort on a clean LEAVE under speculative dispatch.
- One two-process gloo world through ``init()``, the copied coordinator
  and the engine: ``grouped_allreduce`` for every op (SUM/MIN/MAX bitwise
  equal to numpy on integer-valued floats), ``broadcast_parameters``, a
  ``DistributedOptimizer`` step equal to the JAX reference step (1e-4, as
  ``test_torch_train.py``: float32 matmuls summed in another order), a
  digest mismatch that fails only its tensor, and a clean shutdown.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu.ops import collectives as jax_C
from horovod_tpu.ops import engine as jax_engine
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.common.process_sets import ProcessSetTable
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import engine as port_engine
from horovod_tpu_torch.ops import fusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1 << 20


# ------------------------------------------------------------- batching
class _Stacked:
    """What the JAX batching reads of a stacked array: its bytes."""

    def __init__(self, nbytes):
        self.nbytes = nbytes


def _engines(world):
    from horovod_tpu.common.config import Config as JaxConfig
    jeng = jax_engine.CollectiveEngine(types.SimpleNamespace(
        config=JaxConfig(), timeline=None))
    table = ProcessSetTable()
    table.initialize(world, lambda ranks: None)
    peng = port_engine.CollectiveEngine(types.SimpleNamespace(
        config=Config(), process_set_table=table,
        device=torch.device("cpu")))
    return jeng, peng


_F32, _BF16 = torch.float32, torch.bfloat16
# (name, per-rank MB, dtype, group, priority, op, prescale)
BATCH_CASES = {
    "threshold": [(f"g{i}", mb, _F32, -1, 0, "AVERAGE", None)
                  for i, mb in enumerate([10, 12, 9, 40, 1, 1, 20, 33, 0.5])],
    "mixed_dtypes_and_keys": [
        ("a", 8, _F32, -1, 0, "AVERAGE", None),
        ("b", 8, _BF16, -1, 0, "AVERAGE", None),
        ("c", 8, _F32, -1, 0, "SUM", None),
        ("d", 20, _BF16, -1, 0, "AVERAGE", None),
        ("e", 8, _F32, -1, 0, "AVERAGE", 0.5),
        ("f", 2, _BF16, -1, 0, "SUM", None),
        ("g", 8, _F32, -1, 0, "AVERAGE", None)],
    "groups_and_priorities": [
        ("p0", 6, _F32, -1, 1, "AVERAGE", None),
        ("g0.0", 30, _F32, 0, 0, "AVERAGE", None),
        ("g0.1", 30, _BF16, 0, 0, "AVERAGE", None),
        ("p1", 6, _F32, -1, 5, "AVERAGE", None),
        ("g1.0", 1, _F32, 1, 9, "AVERAGE", None),
        ("p2", 25, _BF16, -1, 2, "AVERAGE", None),
        ("g1.1", 1, _F32, 1, 9, "AVERAGE", None),
        ("p3", 40, _F32, -1, 0, "AVERAGE", None)],
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_torch_batching_matches_jax_engine(case):
    """Both engines drain the same entries through their priority queues
    and batch them; the batches are the same lists of names."""
    world = 2
    jeng, peng = _engines(world)
    jents, pents = [], []
    for i, (name, mb, dt, gid, prio, op, pre) in enumerate(BATCH_CASES[case]):
        per_rank = int(mb * MB)
        n = per_rank // torch.tensor([], dtype=dt).element_size()
        jents.append(jax_engine.TensorTableEntry(
            handle=i, name=name, ctype=jax_engine.CollectiveType.ALLREDUCE,
            tensor=_Stacked(per_rank * world),
            reduce_op=getattr(jax_C.ReduceOp, op), group_id=gid,
            priority=prio, prescale_factor=pre))
        pents.append(port_engine.TensorTableEntry(
            handle=i, name=name, ctype=port_engine.CollectiveType.ALLREDUCE,
            tensor=torch.empty(n, dtype=dt, device="meta"),
            reduce_op=getattr(C.ReduceOp, op), group_id=gid, priority=prio,
            prescale_factor=pre))
    jeng.queue.push_many(jents)
    peng.queue.push_many(pents)
    jb, _ = jeng._compute_response_list(jeng.queue.drain())
    pb, _ = peng._compute_response_list(peng.queue.drain())
    names = [[e.name for e in b] for b in pb]
    assert names == [[e.name for e in b] for b in jb]
    assert len(names) > 2


# ----------------------------------------------------------- arithmetic
def _reduce(bufs, op):
    """The collective itself over the ranks' packed buffers (exact on these
    inputs, in any order)."""
    x = torch.stack(bufs)
    if op in ("SUM", "AVERAGE"):
        return x.sum(0).to(bufs[0].dtype)
    if op == "MIN":
        return x.min(0).values
    if op == "MAX":
        return x.max(0).values
    return x.prod(0).to(bufs[0].dtype)


# (case, ranks, dtype, op, prescale, postscale, wire).  A float Average
# runs over four ranks: see test_torch_float_average_divides below.
ARITH_CASES = [
    ("f32_sum_prescale_postscale", 3, np.float32, "SUM", 0.5, 1 / 3, None),
    ("f32_average", 4, np.float32, "AVERAGE", None, None, None),
    ("f32_average_wire_bf16", 4, np.float32, "AVERAGE", 0.5, 1 / 3, "bf16"),
    ("f32_sum_wire_fp16", 3, np.float32, "SUM", None, 0.1, "fp16"),
    ("bf16_average_postscale", 4, "bfloat16", "AVERAGE", None, 1 / 3, None),
    ("f16_average_prescale", 4, np.float16, "AVERAGE", 0.5, None, None),
    ("f16_max_prescale", 3, np.float16, "MAX", 1 / 3, None, None),
    ("f32_min", 3, np.float32, "MIN", None, None, None),
    ("f32_product", 3, np.float32, "PRODUCT", None, None, None),
    ("int32_average_floor", 3, np.int32, "AVERAGE", None, None, None),
    ("int32_sum_prescale", 3, np.int32, "SUM", 0.5, None, None),
    ("int64_average_postscale", 3, np.int64, "AVERAGE", None, 1 / 3, None),
]


def _np_dtype(dt):
    if dt == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16
    return dt


def _to_torch(x):
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


def _jax_and_plain(hvd, n, dt, op, pre, post, wire, seed):
    """The JAX fused program's results over an ``n``-rank process set, and
    the plain pack -> reduction -> plain unpack on the same inputs."""
    rng = np.random.RandomState(seed)
    shapes = [(4, 5), (7,), (2, 3, 2)]
    per_rank = [[rng.randint(-12, 13, s).astype(dt) for s in shapes]
                for _ in range(n)]
    if op == "PRODUCT":
        per_rank = [[np.clip(np.abs(x.astype(np.float32)), 1, 3).astype(dt)
                     for x in xs] for xs in per_rank]
    ps = hvd.add_process_set(list(range(n)))
    try:
        ref = hvd.grouped_allreduce(
            [hvd.stack_per_rank([per_rank[r][i] for r in range(n)], ps)
             for i in range(len(shapes))],
            op=getattr(hvd, op.capitalize()), prescale_factor=pre,
            postscale_factor=post, process_set=ps, compression=wire)
        ref = [np.asarray(x) for x in ref]
    finally:
        hvd.remove_process_set(ps)
    ins = [[_to_torch(x) for x in xs] for xs in per_rank]
    buf_dt = fusion.buffer_dtype(ins[0][0].dtype,
                                 port_engine.WIRE_DTYPES.get(wire))
    bufs = [fusion.pack(xs, buf_dt, pre) for xs in ins]
    outs = [torch.empty_like(x) for x in ins[0]]
    fusion.unpack(_reduce(bufs, op), outs, n if op == "AVERAGE" else 1,
                  post)
    outs = [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy()
            for o in outs]
    return [np.asarray(r).astype(o.dtype) for r, o in zip(ref, outs)], outs


@pytest.mark.parametrize("case,n,dt,op,pre,post,wire", ARITH_CASES,
                         ids=[c[0] for c in ARITH_CASES])
def test_torch_pack_unpack_match_jax_fused_program(hvd, case, n, dt, op, pre,
                                                   post, wire):
    ref, got = _jax_and_plain(hvd, n, _np_dtype(dt), op, pre, post, wire,
                              seed=len(case))
    for g, want in zip(got, ref):
        assert np.array_equal(g, want), (case, g, want)


@pytest.mark.parametrize("dt,wire", [(np.float32, None),
                                     ("bfloat16", None), (np.float16, None),
                                     (np.float32, "bf16")])
def test_torch_float_average_divides(hvd, dt, wire):
    """Over three ranks the port divides the sum by 3 in the buffer's dtype
    and rounds there, as ``engine.py:2035-2037`` is written.  XLA's CPU
    backend compiles that division by a constant into a multiply by the
    reciprocal, and lets a bf16 quotient keep float32 precision up to the
    cast back, so the JAX program differs by at most one unit in the last
    place of the buffer's dtype (ROADMAP queue 3)."""
    dt = _np_dtype(dt)
    ref, got = _jax_and_plain(hvd, 3, dt, "AVERAGE", None, None, wire,
                              seed=5)
    ulp = {np.float32: 2.0 ** -23, np.float16: 2.0 ** -10}.get(dt, 2.0 ** -7)
    if wire == "bf16":
        ulp = 2.0 ** -7
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g, want, rtol=ulp, atol=0)
    rng = np.random.RandomState(5)
    per_rank = [[rng.randint(-12, 13, s).astype(dt)
                 for s in [(4, 5), (7,), (2, 3, 2)]] for _ in range(3)]
    buf_dt = torch.bfloat16 if wire == "bf16" else _to_torch(
        per_rank[0][0]).dtype
    for i, g in enumerate(got):
        total = sum(_to_torch(per_rank[r][i]).to(buf_dt) for r in range(3))
        want = (total / 3).to(_to_torch(per_rank[0][i]).dtype)
        want = want.float().numpy() if want.dtype == torch.bfloat16 \
            else want.numpy()
        assert np.array_equal(g, want)


# ------------------------------------------------------ repaired faults
def test_torch_scale_rounds_the_factor_to_the_dtype():
    """Fault 1: a bf16 tensor times a Python float scaled in float32 with
    the unrounded factor (the pre-engine mpi_ops._scale); the JAX package
    rounds the factor to the tensor's dtype first."""
    x = torch.tensor([3.0, 7.0, 11.0], dtype=torch.bfloat16)
    want = np.asarray(jax_C._scale(jnp.asarray([3, 7, 11], jnp.bfloat16),
                                   1 / 3)).astype(np.float32)
    assert want.tolist() == [1.0, 2.34375, 3.671875]
    assert (x * (1 / 3)).float().tolist() == [1.0, 2.328125, 3.671875]
    assert C._scale(x, 1 / 3).float().tolist() == want.tolist()
    out = torch.empty_like(x)
    fusion.unpack(fusion.pack([x], torch.bfloat16, 1 / 3), [out])
    assert out.float().tolist() == want.tolist()
    fusion.unpack(x.clone(), [out], postscale=1 / 3)
    assert out.float().tolist() == want.tolist()


def test_torch_average_floor_divides_integers(hvd):
    """Fault 2: Average was a multiply by 1/n through float32, which
    truncates toward zero; the JAX package floor-divides integers.  The
    int32 sum -3 over two ranks averages to -2."""
    ps = hvd.add_process_set([0, 1])
    try:
        ref = np.asarray(hvd.allreduce(hvd.stack_per_rank(
            [np.array([-1, 3], np.int32), np.array([-2, 2], np.int32)], ps),
            op=hvd.Average, process_set=ps))
    finally:
        hvd.remove_process_set(ps)
    assert ref.tolist() == [-2, 2]
    out = torch.empty(2, dtype=torch.int32)
    fusion.unpack(torch.tensor([-3, 5], dtype=torch.int32), [out], divisor=2)
    assert out.tolist() == ref.tolist()


class _LeaveController:
    """What the engine reads of a controller in a round whose leave notice
    names rank 1, with speculative dispatch armed."""
    left_ranks = [1]
    spec_ready_after = 1
    spec_dispatch_ok = True

    def negotiate(self, entries):
        return list(entries), []

    def forget(self, e):
        pass


class _NeverDone:
    """A done event whose collective never completes (until released)."""

    def __init__(self, release):
        self._release = release

    def synchronize(self):
        self._release.wait()


def test_torch_leave_notice_aborts_the_inflight_window():
    """A world allreduce dispatched from a predicted verdict in the round a
    peer left can never complete: on the leave notice the engine settles
    its in-flight window with PeerLeftInterrupt (the JAX engine's
    ``engine.py:1252-1268``), so the waiter does not hang.  The engine is
    the card's (speculation needs its asynchronous launches)."""
    from horovod_tpu_torch.common.exceptions import PeerLeftInterrupt
    table = ProcessSetTable()
    table.initialize(2, lambda ranks: None)
    eng = port_engine.CollectiveEngine(types.SimpleNamespace(
        config=Config(), process_set_table=table,
        device=torch.device("cuda")))
    eng.controller = _LeaveController()
    x = torch.zeros(3)
    e = port_engine.TensorTableEntry(
        handle=1, name="grad", ctype=port_engine.CollectiveType.ALLREDUCE,
        tensor=x, output=x)
    eng._handles[e.handle] = e
    release = threading.Event()
    ring = eng._inflight_ring()
    try:
        ring.submit([e], ([x], _NeverDone(release), None))
        eng._compute_response_list([])
        with pytest.raises(PeerLeftInterrupt):
            eng.synchronize(e.handle, timeout=5)
        assert len(ring) == 0
    finally:
        release.set()
        ring.stop()


@pytest.mark.parametrize("ptrs,sizes,bulk", [
    ((0x1000, 0x2000), (32, 7), 1),
    ((0x1000, 0x2008), (32, 16), 0),
    ((0x1000, 0x2000), (24, 16), 0),
    ((0x1000, 0x7, 0x2000), (16, 0, 5), 1)],
    ids=["last-ragged", "base-off-16", "place-off-16", "empty-between"])
def test_torch_byte_path_takes_bulk_copies_when_aligned(ptrs, sizes, bulk):
    """The byte path's bulk copies need every tensor's base and its place
    in the buffer on a 16-byte boundary (an empty tensor's pointer is never
    read, and the last tensor may end anywhere); the buffer's base too."""
    offs = fusion._offsets(sizes)
    assert fusion._aligned(0x10000, ptrs, offs, sizes) == bulk
    assert fusion._aligned(0x10008, ptrs, offs, sizes) == 0


def test_torch_fusion_wrappers_refuse_what_they_do_not_take():
    x = torch.arange(12.0).reshape(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fusion.pack([x.t()], torch.float32)
    with pytest.raises(ValueError, match="one dtype group"):
        fusion.pack([x, x.int()], torch.float32)
    with pytest.raises(ValueError, match="float group"):
        fusion.pack([x.int()], torch.bfloat16)
    with pytest.raises(ValueError, match="elements"):
        fusion.unpack(torch.zeros(5), [torch.empty(4)])


# ------------------------------------------------ a two-process gloo world
_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.controller import NegotiationError
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import fusion
    out_dir = sys.argv[2]
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    assert n == 2
    eng = hvd.common.basics._get_state().engine

    # grouped_allreduce for every op: integer-valued floats and ints.
    arrs = [[np.random.RandomState(10 * i + j).randint(-9, 10, s)
             .astype(np.float32) for j, s in enumerate([(3, 5), (4,)])]
            for i in range(n)]
    mine = [torch.from_numpy(a.copy()) for a in arrs[r]]
    ints = [torch.tensor([-1 - r, 3 + r, 4], dtype=torch.int32)]
    for op, ref in ((hvd.Sum, np.sum), (hvd.Min, np.min), (hvd.Max, np.max)):
        outs = hvd.grouped_allreduce(mine + ints, op=op)
        for k, o in enumerate(outs[:2]):
            assert np.array_equal(o.numpy(), ref(np.stack(
                [arrs[0][k], arrs[1][k]]), 0)), (op, k)
    prod = hvd.grouped_allreduce(mine, op=hvd.Product)
    assert np.array_equal(prod[0].numpy(), arrs[0][0] * arrs[1][0])
    avg = hvd.grouped_allreduce(mine + ints, op=hvd.Average)
    assert np.array_equal(avg[0].numpy(), (arrs[0][0] + arrs[1][0]) / 2)
    assert avg[2].tolist() == [-2, 3, 4], avg[2]     # floor of -3 / 2
    for t, a in zip(mine, arrs[r]):
        assert np.array_equal(t.numpy(), a)          # inputs untouched

    # A digest mismatch fails only its own tensor.
    bad = hvd.allreduce_async(torch.zeros(3 + r), name="mismatch")
    good = hvd.allreduce_async(torch.ones(2) * (r + 1), name="fine",
                               op=hvd.Sum)
    try:
        hvd.synchronize(bad)
        raise SystemExit("the mismatched tensor did not fail")
    except NegotiationError:
        pass
    assert hvd.synchronize(good).tolist() == [3.0, 3.0]

    # Parameters: rank 1 starts from other weights; the broadcast makes
    # them rank 0's (the JAX initial parameters), fused into one batch.
    cfg = tl.tiny(dtype=torch.float32)
    with open(sys.argv[3], "rb") as fh:
        params = tl.params_from_jax(pickle.load(fh))
    named = list(tl.named_parameters(params))
    if r == 1:
        with torch.no_grad():
            for _, t in named:
                t.add_(1.0)
    groups0 = eng.fused_groups
    hvd.broadcast_parameters(params, root_rank=0)
    assert eng.fused_groups == groups0 + 1, eng.fused_groups
    for _, t in named:
        t.requires_grad_(True)

    # One step on half the batch per rank.
    toks = np.random.RandomState(7).randint(0, 256, (4, 25)).astype(np.int64)
    x, y = torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=0.5),
        named_parameters=named)
    tl.make_train_step(cfg, opt)(params, x[2 * r:2 * r + 2],
                                 y[2 * r:2 * r + 2])
    np.savez(f"{out_dir}/params{r}.npz",
             **{k: t.detach().numpy() for k, t in named})
    ctl = eng.controller
    assert ctl.cache_stats.misses > 0 and eng.pipeline_dispatches > 0
    hvd.shutdown()
    assert not hvd.is_initialized()
    print("ENGINE2_OK", r)
""")


def test_torch_engine_two_process_gloo(tmp_path):
    jcfg = jl.tiny(dtype=jnp.float32, dp_axis=None, tp_axis=None,
                   sp_axis=None, use_flash=False)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    with open(tmp_path / "params.pkl", "wb") as fh:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jparams), fh)
    script = tmp_path / "engine2.py"
    script.write_text(_WORKER)
    port, port2 = free_ports(2)
    t0 = time.monotonic()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_CONTROLLER_PORT2=str(port2))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), REPO, str(tmp_path),
             str(tmp_path / "params.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        finally:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"ENGINE2_OK {r}" in out, out
    assert time.monotonic() - t0 < 60

    # The JAX reference step on the whole batch.
    toks = np.random.RandomState(7).randint(0, 256, (4, 25)).astype(np.int32)
    tx = optax.sgd(0.5)
    ref, _, _ = jax.jit(jl.make_train_step(jcfg, tx))(
        jparams, tx.init(jparams), jnp.asarray(toks[:, :-1]),
        jnp.asarray(toks[:, 1:]))
    ref = {n: t.numpy() for n, t in tl.named_parameters(
        tl.params_from_jax(jax.tree_util.tree_map(np.asarray, ref)))}
    got = [np.load(tmp_path / f"params{r}.npz") for r in range(2)]
    assert sorted(got[0].files) == sorted(ref)
    for n in ref:
        assert np.array_equal(got[0][n], got[1][n]), n
        np.testing.assert_allclose(got[0][n], ref[n], atol=1e-4, rtol=1e-4,
                                   err_msg=n)
