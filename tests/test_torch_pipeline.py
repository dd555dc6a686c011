"""Chunked pipelining in the port's engine against the JAX engine's.

- ``_chunk_plan`` (a per-dtype-group chunk COUNT) against the JAX method,
  both called unbound on a stub that holds ``pipeline_chunk_bytes`` (the
  JAX one on stacked ``[world, *S]`` shapes and dtype names, the port's on
  per-rank shapes and torch dtypes); ``_chunk_bounds`` keeps the count and
  puts every inner boundary on 16 bytes.
- A gloo world of 2 through the port's launcher: every case chunked and
  unchunked, bitwise (at two ranks each element is one add, whatever the
  chunk); each against the JAX engine with the same knob on the process
  set [0, 1] of the 8-device CPU mesh, bitwise; the chunk counters.
- A gloo world of 4 in two slices of 2 (``--hierarchical-allreduce``,
  ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``): the two-level path chunked
  against unchunked.  Integer-valued floats are exact in every order of
  the reduction, so they are held bitwise; random floats at 4 ranks are
  held to rtol 1e-6 (gloo may pick its algorithm by buffer size) and
  whether they came out bitwise anyway is recorded.
- ``_Timing``: an unchunked batch's parts tile its span (overlap 0); a
  chunked batch's collective runs from the later of its pack's end and
  the previous collective's end.

The card's cases (chunked and partitioned allreduces bitwise, a ping-pong
buffer reused only after its batch's done event) are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops import engine as jengine
from horovod_tpu_torch.ops import engine as pengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NP = {torch.float32: "float32", torch.bfloat16: "bfloat16",
       torch.float16: "float16", torch.int32: "int32", torch.int64: "int64",
       torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
       torch.float64: "float64", torch.complex64: "complex64"}

# (knob bytes, per-rank shapes, dtypes)
PLAN_CASES = [
    (1024, [(512,), (512,), (100,)],
     [torch.float32, torch.float32, torch.int32]),
    (0, [(512,)], [torch.float32]),
    (1, [(3,)], [torch.float32]),
    (64, [(257,), (33, 5), (7,)], [torch.float32, torch.float32,
                                   torch.bfloat16]),
    (130, [(64,)], [torch.float32]),
    (4096, [(), (1000, 3), (10,), (5, 5)],
     [torch.bfloat16, torch.bfloat16, torch.uint8, torch.complex64]),
    (256 << 20, [(32000, 4096), (4096, 14336)], [torch.bfloat16] * 2),
    (7, [(9,), (2,)], [torch.int8, torch.bool]),
]


@pytest.mark.parametrize("knob,shapes,dtypes", PLAN_CASES)
def test_torch_chunk_plan_matches_jax(knob, shapes, dtypes):
    """The same knob and batch give the same counts, allreduce only."""
    stub = types.SimpleNamespace(pipeline_chunk_bytes=knob)
    world = 2
    stacked = [(world,) + s for s in shapes]
    names = [_NP[d] for d in dtypes]
    for ct in ("ALLREDUCE", "ALLGATHER", "REDUCESCATTER"):
        want = jengine.CollectiveEngine._chunk_plan(
            stub, jengine.CollectiveType[ct], stacked, names)
        got = pengine.CollectiveEngine._chunk_plan(
            stub, pengine.CollectiveType[ct], shapes, dtypes)
        assert got == want, (ct, got, want)


@pytest.mark.parametrize("n,count,sizes", [
    (422, 27, (4, 4)), (422, 27, (4, 2)), (100, 10, (4,)),
    (5, 5, (4,)), (9, 4, (2, 4)), (1 << 20, 3, (2,)), (16, 2, (8,)),
    (10, 1, (4,))])
def test_torch_chunk_bounds_keep_the_count_on_16_bytes(n, count, sizes):
    """``count`` chunks tile ``[0, n)`` in order; every inner boundary is
    a multiple of 16 bytes in each dtype; a chunk is empty only where n is
    under count × 16 bytes' worth of elements."""
    b = pengine._chunk_bounds(n, count, sizes)
    assert len(b) == count + 1 and b[0] == 0 and b[-1] == n
    assert all(x <= y for x, y in zip(b, b[1:]))
    for x in b[1:-1]:
        assert all((x * s) % 16 == 0 for s in sizes), (x, sizes)
    g = max(1, 16 // min(sizes))
    if n >= count * g:
        assert all(x < y for x, y in zip(b, b[1:])), b


def test_torch_timing_parts_tile_or_overlap():
    """``_Timing`` on the host clock: three contiguous parts sum to the
    span; a chunk's collective starts at the later of its starts."""
    t = pengine._Timing(host=True)
    t.marks = [0.0, 1.0, 3.0, 6.0]
    t.parts = [(0, (0,), 1), (1, (1,), 2), (2, (2,), 3)]
    assert t.parts_us() == (1e6, 2e6, 3e6)
    assert t.reduce_s() == 6.0
    # pack0 0-1, pack1 1-2, coll0 end 4 (from pack0's end), unpack0 4-5,
    # coll1 end 7 from max(pack1 end 2, coll0 end 4), unpack1 7-8.
    t.marks = [0.0, 1.0, 2.0, 4.0, 5.0, 7.0, 8.0]
    t.parts = [(0, (0,), 1), (0, (1,), 2), (1, (1,), 3), (2, (3,), 4),
               (1, (2, 3), 5), (2, (5,), 6)]
    pack, coll, unpack = t.parts_us()
    assert (pack, coll, unpack) == (2e6, 6e6, 2e6)
    assert pack + coll + unpack - t.reduce_s() * 1e6 == 2e6   # overlap


# ------------------------------------------------------------ gloo worlds
def _inputs(rank):
    """Each rank's inputs: (name, op, kwargs, arrays)."""
    rng = np.random.RandomState(100 + rank)
    f = lambda *s: (rng.randn(*s) * (rank + 1)).astype(np.float32)  # noqa
    ints = lambda *s: rng.randint(-50, 50, s).astype(np.float32)    # noqa
    return [
        ("f32_sum", "Sum", {}, [f(257), f(33, 5)]),
        ("bf16_wire", "Sum", {"compression": "bf16"}, [f(257), f(33, 5)]),
        ("avg_factors", "Average", {"prescale_factor": 0.5,
                                    "postscale_factor": 3.0}, [f(129)]),
        ("mixed", "Sum", {}, [f(300), f(41).astype(ml_dtypes.bfloat16),
                              rng.randint(-9, 9, 77).astype(np.int32)]),
        ("min", "Min", {}, [f(500)]),
        ("max", "Max", {}, [f(500)]),
        ("int_avg", "Average", {}, [rng.randint(-99, 99, 321)
                                    .astype(np.int32)]),
        ("ints_exact", "Sum", {}, [ints(611), ints(17, 3)]),
    ]


CASES = [c[0] for c in _inputs(0)]
KNOB = 64                          # bytes: many chunks a group


_WORKER = textwrap.dedent("""
    import pickle, sys
    import ml_dtypes, numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.common.basics._get_state().engine
    with open(sys.argv[2], "rb") as fh:
        cases, knob = pickle.load(fh)
    cases = cases[r]

    def T(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    def N(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    out = {"size": hvd.size(), "hier": eng._hier is not None}
    for name, op, kw, arrays in cases:
        res = {}
        for knob_now in (0, knob):
            eng.pipeline_chunk_bytes = knob_now
            c0, d0 = eng.pipeline_chunks_total, eng.pipeline_dispatches
            g0 = eng.fused_groups
            outs = eager.grouped_allreduce([T(a) for a in arrays],
                                           op=getattr(hvd, op),
                                           name=f"{name}.{knob_now}",
                                           **kw)
            res[knob_now] = dict(
                outs=[N(o) for o in outs],
                chunks=eng.pipeline_chunks_total - c0,
                batches=eng.pipeline_dispatches - d0,
                groups=eng.fused_groups - g0)
        out[name] = res
    eng.pipeline_chunk_bytes = 0
    out["hier_dispatches"] = eng.hier_dispatches
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("PIPELINE_OK", r)
""")


def _launch(tmp, world, flags=(), env_extra=None, timeout=180):
    """The worker in a gloo world of ``world`` through the port's
    launcher; each rank's pickled result."""
    with open(tmp / "ins.pkl", "wb") as fh:
        pickle.dump(([_inputs(r) for r in range(world)], KNOB), fh)
    (tmp / "w.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_TPU_"))}
    env.update(PYTHONPATH=REPO, **(env_extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(world), *flags, "--output-filename", str(tmp / "logs"),
         sys.executable, str(tmp / "w.py"), REPO, str(tmp / "ins.pkl"),
         str(tmp / "out")], env=env, cwd=str(tmp), timeout=timeout)
    logs = ""
    for r in range(world):
        for f in ("stdout", "stderr"):
            p = tmp / "logs" / f"rank.{r}" / f
            if p.exists():
                logs += p.read_text()[-2000:]
    assert proc.returncode == 0, logs
    outs = []
    for r in range(world):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("pipeline2"), 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("pipeline4"), 4,
                   ("--hierarchical-allreduce",),
                   {"HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2"})


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                       b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


@pytest.mark.parametrize("case", CASES)
def test_torch_chunked_allreduce_bitwise_unchunked_at_two_ranks(world2,
                                                                case):
    """At two ranks each element is one add: the chunked result is the
    unchunked one bit for bit, on both ranks, and the chunk counter adds
    the plan's total (more chunks than batches)."""
    for r in range(2):
        res = world2[r][case]
        for a, b in zip(res[0]["outs"], res[KNOB]["outs"]):
            _same(a, b)
        assert res[0]["chunks"] == res[0]["batches"] == 1
        assert res[KNOB]["chunks"] > res[KNOB]["batches"] == 1


@pytest.fixture()
def jax_ps(hvd):
    ps = hvd.add_process_set([0, 1])
    yield ps
    hvd.remove_process_set(ps)


@pytest.mark.parametrize("case", CASES)
def test_torch_chunked_allreduce_matches_jax_engine(hvd, jax_ps, world2,
                                                    case):
    """The port's chunked result is the JAX engine's with the same knob
    (its chunked program on the process set [0, 1]), bitwise; and the
    port's chunk count is the JAX plan's total."""
    from horovod_tpu.common import basics
    eng = basics._get_state().engine
    ins = {r: dict((c[0], c) for c in _inputs(r))[case] for r in range(2)}
    _, op, kw, _ = ins[0]
    saved = eng.pipeline_chunk_bytes
    eng.pipeline_chunk_bytes = KNOB
    try:
        refs = hvd.grouped_allreduce(
            [hvd.stack_per_rank([ins[r][3][i] for r in range(2)], jax_ps)
             for i in range(len(ins[0][3]))], op=getattr(hvd, op),
            process_set=jax_ps, name=f"jax.{case}", **kw)
        shapes = tuple((2,) + a.shape for a in ins[0][3])
        names = tuple(str(a.dtype) for a in ins[0][3])
        plan = eng._chunk_plan(jengine.CollectiveType.ALLREDUCE, shapes,
                               names)
    finally:
        eng.pipeline_chunk_bytes = saved
    for r in range(2):
        got = world2[r][case][KNOB]
        for a, b in zip(got["outs"], refs):
            _same(a, np.asarray(b))
        assert got["chunks"] == sum(plan)


@pytest.mark.parametrize("case", CASES)
def test_torch_chunked_two_level_against_unchunked_at_four_ranks(
        world4, case, record_property):
    """Two-level (reduce-scatter local -> allreduce cross -> allgather
    local) chunk by chunk: integers and integer-valued floats bitwise, the
    rest within rtol 1e-6 (recorded as ``bitwise`` when they were anyway);
    every rank the same bits."""
    assert world4[0]["size"] == 4 and world4[0]["hier"]
    assert world4[0]["hier_dispatches"] >= 2 * len(CASES)
    exact = case in ("ints_exact", "int_avg", "min", "max")
    bitwise = True
    for r in range(4):
        res = world4[r][case]
        for a, b in zip(res[0]["outs"], res[KNOB]["outs"]):
            a, b = np.asarray(a), np.asarray(b)
            bitwise = bitwise and a.tobytes() == b.tobytes()
            if exact or a.dtype.kind in "iub":
                _same(a, b)
            else:
                np.testing.assert_allclose(a.astype(np.float64),
                                           b.astype(np.float64), rtol=1e-6,
                                           atol=1e-6)
        for a, b in zip(res[KNOB]["outs"], world4[0][case][KNOB]["outs"]):
            _same(a, b)
        assert res[KNOB]["chunks"] > 1
    record_property("bitwise", bitwise)
