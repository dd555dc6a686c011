"""Dtypes through the port's engine, against the JAX engine.

- Broadcast groups go by bytes: the fusion wrappers' byte path packs and
  unpacks them, and the collective sees the buffer as uint8, for dtypes
  NCCL has no type for (int16, complex) as for the rest.  Checked with a
  stub ``torch.distributed.broadcast`` over a set of two.
- Parity: a two-process gloo world broadcasts one tensor of each dtype the
  JAX package holds without x64 from rank 1 through the port's engine; the
  result is bitwise root's tensor and bitwise the JAX engine's broadcast of
  the same inputs.  The inputs hold no -0.0 and no NaN: the JAX broadcast
  is a psum of root's value and zeros, which turns -0.0 into +0.0.
- An allreduce gives the JAX engine's outcome for every dtype it holds
  without x64, on both devices: bool counts in int32 (``Min``/``Max`` stay
  bool), int16 reduces in int16 (int32 on the wire, wrapping as the JAX
  program's int16 sum wraps), int8/int16 ``Product`` returns int32 and
  uint8 ``Product`` uint32, complex ``Sum``/``Product`` work.  What the
  JAX engine refuses (complex ``Average``/``Min``/``Max``) the port
  refuses at submission, on the card as on the CPU; the same world pins
  every case against the JAX engine.
- A reducescatter does the same for bool, int8, uint8, int16 and complex64
  under the five ops: int16 travels as int32 and its sum wraps back to
  int16 (also before an ``Average``'s ``/``, which returns float32, as for
  every integer dtype), bool ``Min``/``Max`` stay bool and ``Product``
  counts in int32, bool ``Sum``/``Average`` raise as in the JAX engine
  (its ``psum_scatter`` adds no bool), and complex64 takes every op
  (``Min``/``Max`` by real part, then imaginary part).
"""

import os
import subprocess
import sys
import textwrap
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.net import free_ports
from horovod_tpu_torch.common.process_sets import ProcessSetTable
from horovod_tpu_torch.ops import engine as port_engine
from horovod_tpu_torch.ops import fusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The dtypes JAX holds without x64, by torch name.
PARITY = ["bool", "uint8", "int8", "int16", "int32", "float32", "bfloat16",
          "float16", "complex64"]
ROUTED = ["bool", "uint8", "int8", "int16", "float64", "complex64"]


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _values(name, rank, n=23):
    """Rank ``rank``'s tensor of dtype ``name`` as numpy: seeded, no -0.0,
    no NaN."""
    rng = np.random.RandomState(100 + 7 * rank + PARITY.index(name))
    if name == "bool":
        return rng.randint(0, 2, n).astype(bool)
    if name == "complex64":
        return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    dt = _np_dtype(name)
    if np.issubdtype(np.dtype(dt), np.integer):
        info = np.iinfo(dt)
        return rng.randint(info.min, int(info.max) + 1, n).astype(dt)
    return (rng.randn(n) * 3 + 0.25).astype(dt)


def _to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


# ---------------------------------------------------------------- routing
def _engine(world, device="cpu"):
    table = ProcessSetTable()
    table.initialize(world, lambda ranks: None)
    return port_engine.CollectiveEngine(types.SimpleNamespace(
        config=Config(), process_set_table=table,
        device=torch.device(device)))


@pytest.mark.parametrize("name", ROUTED)
def test_torch_broadcast_group_goes_by_bytes(monkeypatch, name):
    eng = _engine(2)
    seen, paths = [], []
    monkeypatch.setattr(torch.distributed, "broadcast",
                        lambda t, src, group: seen.append(t.dtype))
    for path in ("_pack_bytes", "_unpack_bytes"):
        real = getattr(fusion, path)

        def spy(*args, _real=real, _path=path):
            paths.append(_path)
            return _real(*args)
        monkeypatch.setattr(fusion, path, spy)
    dt = getattr(torch, name)
    xs = [_to_torch(_values("complex64", r, 11 + r)).to(dt) if dt.is_complex
          else _to_torch(_values("int8", r, 11 + r)).to(dt) for r in range(2)]
    batch = [port_engine.TensorTableEntry(
        handle=i, name=f"b{i}", ctype=port_engine.CollectiveType.BROADCAST,
        tensor=x, output=torch.empty_like(x)) for i, x in enumerate(xs)]
    outs = eng._run_groups(batch, eng._state.process_set_table.get(0))
    assert seen == [torch.uint8]
    assert paths == ["_pack_bytes", "_unpack_bytes"]
    for o, x in zip(outs, xs):
        assert o.dtype == dt and torch.equal(o, x)


# The JAX engine's Average of each dtype (complex: floor_divide raises).
_AVERAGE = {"int16": "int16", "bool": "int32", "complex64": None,
            "complex128": None, "float64": "float64", "int8": "int8",
            "uint8": "uint8"}


@pytest.mark.parametrize("name", list(_AVERAGE))
def test_torch_card_allreduce_refuses_at_submission(name):
    """An engine on the card refuses at submission what the JAX engine
    refuses too, naming the op: a complex Average.  It takes the rest,
    with an output of the JAX engine's result dtype.  (The tensors are CPU
    tensors: the check reads only the dtype, and nothing runs a cycle.)"""
    eng = _engine(1, device="cuda")
    x = torch.zeros(3, dtype=getattr(torch, name))
    submit = lambda: eng.enqueue(  # noqa: E731
        "g", port_engine.CollectiveType.ALLREDUCE, x)
    if _AVERAGE[name] is None:
        with pytest.raises(TypeError, match=f"{name} takes Sum and Product"):
            submit()
        assert len(eng.queue.drain()) == 0
    else:
        submit()
        e, = eng.queue.drain()
        assert e.output.dtype == getattr(torch, _AVERAGE[name])
    # A broadcast of any dtype is taken.
    eng.enqueue("b", port_engine.CollectiveType.BROADCAST, x, output=x)


# ------------------------------------------------- a two-process gloo world
_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)[r]
    out = {}
    for name, x in ins["bcast"].items():
        t = torch.from_numpy(x).view(getattr(torch, name))
        out[("bcast", name)] = hvd.broadcast(t, root_rank=1, name=name)\\
            .reshape(-1).view(torch.uint8).numpy().tobytes()
    for (name, op), x in ins["reduce"].items():
        t = torch.from_numpy(x)
        try:
            res = hvd.allreduce(t, op=getattr(hvd, op),
                                name=f"{name}.{op}")
            out[(name, op)] = (str(res.dtype)[6:], res.tolist())
        except Exception as exc:
            out[(name, op)] = ("raises", type(exc).__name__)
    for (name, op), x in ins["scatter"].items():
        try:
            res = hvd.reducescatter(torch.from_numpy(x),
                                    op=getattr(hvd, op),
                                    name=f"rs.{name}.{op}")
            out[("rs", name, op)] = (str(res.dtype)[6:], res.tolist())
        except Exception as exc:
            out[("rs", name, op)] = ("raises", type(exc).__name__)
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("DTYPES_OK", r)
""")

# The allreduce of the dtypes NCCL and gloo do not reduce as the JAX engine
# does, on this world's inputs: the int16 sum of 30000 and 30000 wraps,
# and the int8 and uint8 products leave their dtype.
_REDUCE_INPUTS = {
    "bool": [np.array([True, False, True]), np.array([True, True, False])],
    "int16": [np.array([30000, -2, 300], np.int16),
              np.array([30000, 5, -7], np.int16)],
    "int8": [np.array([100, 3, -7], np.int8), np.array([3, 90, 2], np.int8)],
    "uint8": [np.array([100, 3, 7], np.uint8),
              np.array([3, 90, 2], np.uint8)],
    "complex64": [np.array([1 + 2j, -1j, 3], np.complex64),
                  np.array([2 - 1j, 4, 0.5j], np.complex64)]}
_OPS = ("Sum", "Average", "Min", "Max", "Product")
CPU_PIN = {(n, op): "agrees" for n in _REDUCE_INPUTS for op in _OPS}
CPU_PIN.update({("complex64", op): "both raise"
                for op in ("Average", "Min", "Max")})

# The reducescatter's inputs, four elements a rank (two a rank's chunk):
# int16 30000 + 30000, int8 100 + 30 and uint8 200 + 100 wrap; complex
# 1 and 1+1j tie on the real part.  "int16 [1, 2]" is int16 [1, 2] from
# each rank, Sum: [2] and [4].
_SCATTER_INPUTS = {
    "bool": [np.array([True, False, True, True]),
             np.array([True, True, False, False])],
    "int16": [np.array([30000, -2, 1, 2], np.int16),
              np.array([30000, 5, -7, 3], np.int16)],
    "int8": [np.array([100, 3, -7, 4], np.int8),
             np.array([30, 90, 2, 50], np.int8)],
    "uint8": [np.array([200, 3, 7, 200], np.uint8),
              np.array([100, 90, 2, 100], np.uint8)],
    "complex64": [np.array([1 + 2j, -1j, 3, 1], np.complex64),
                  np.array([2 - 1j, 4, 0.5j, 1 + 1j], np.complex64)]}
SCATTER_PIN = {(n, op): "agrees" for n in _SCATTER_INPUTS for op in _OPS}
SCATTER_PIN.update({("bool", op): "both raise" for op in ("Sum",
                                                          "Average")})
SCATTER_PIN[("int16 [1, 2]", "Sum")] = "agrees"


def _scatter_inputs(name):
    if name == "int16 [1, 2]":
        return [np.array([1, 2], np.int16)] * 2
    return _SCATTER_INPUTS[name]


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    import pickle
    tmp = tmp_path_factory.mktemp("dtypes")
    # Broadcast inputs travel as raw bytes (numpy has no bfloat16 that
    # torch reads) and are viewed back as their dtype in the worker.
    ins = [{"bcast": {n: _to_torch(_values(n, r)).view(torch.uint8).numpy()
                      for n in PARITY},
            "reduce": {(n, op): xs[r] for n, xs in _REDUCE_INPUTS.items()
                       for op in _OPS},
            "scatter": {(n, op): _scatter_inputs(n)[r]
                        for n, op in SCATTER_PIN}}
           for r in range(2)]
    with open(tmp / "ins.pkl", "wb") as fh:
        pickle.dump(ins, fh)
    script = tmp / "dtypes.py"
    script.write_text(_WORKER)
    port, port2 = free_ports(2)
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
            logs.append(p.communicate(timeout=90)[0])
        finally:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        assert f"DTYPES_OK {r}" in log, log
    outs = []
    for r in range(2):
        with open(tmp / f"out.{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _jax_ps(hvd):
    return hvd.add_process_set([0, 1])


@pytest.mark.parametrize("name", PARITY)
def test_torch_broadcast_matches_jax_engine(hvd, gloo_world, name):
    ps = _jax_ps(hvd)
    try:
        ref = np.asarray(hvd.broadcast(hvd.stack_per_rank(
            [_values(name, r) for r in range(2)], ps), root_rank=1,
            process_set=ps))
    finally:
        hvd.remove_process_set(ps)
    assert ref.dtype == _np_dtype(name)
    root = _values(name, 1)
    assert ref.tobytes() == root.tobytes()
    for r in range(2):
        assert gloo_world[r][("bcast", name)] == root.tobytes(), (name, r)


@pytest.mark.parametrize("case", sorted(CPU_PIN), ids="-".join)
def test_torch_cpu_allreduce_dtype_pin(hvd, gloo_world, case):
    name, op = case
    ps = _jax_ps(hvd)
    try:
        ref = np.asarray(hvd.allreduce(hvd.stack_per_rank(
            _REDUCE_INPUTS[name], ps), op=getattr(hvd, op), process_set=ps))
        ref = (ref.dtype.name, ref.tolist())
    except Exception as exc:  # noqa: BLE001 - the outcome is pinned
        ref = ("raises", type(exc).__name__)
    finally:
        hvd.remove_process_set(ps)
    got = gloo_world[0][case]
    assert gloo_world[1][case] == got
    if got[0] == "raises":
        seen = "both raise" if ref[0] == "raises" else "port raises"
    else:
        seen = "agrees" if got == ref else "differs"
    assert seen == CPU_PIN[case], (case, got, ref)


def _pinned(got, ref):
    if got[0] == "raises":
        return "both raise" if ref[0] == "raises" else "port raises"
    return "agrees" if got == ref else "differs"


@pytest.mark.parametrize("case", sorted(SCATTER_PIN), ids="-".join)
def test_torch_cpu_reducescatter_dtype_pin(hvd, gloo_world, case):
    """Each rank's chunk of a reducescatter through the port's engine
    against the JAX engine's row for that rank: the same dtype and values,
    or both raise."""
    name, op = case
    ps = _jax_ps(hvd)
    try:
        ref = np.asarray(hvd.reducescatter(hvd.stack_per_rank(
            _scatter_inputs(name), ps), op=getattr(hvd, op),
            process_set=ps))
        refs = [(ref.dtype.name, ref[r].tolist()) for r in range(2)]
    except Exception as exc:  # noqa: BLE001 - the outcome is pinned
        refs = [("raises", type(exc).__name__)] * 2
    finally:
        hvd.remove_process_set(ps)
    seen = {_pinned(gloo_world[r][("rs",) + case], refs[r])
            for r in range(2)}
    assert seen == {SCATTER_PIN[case]}, (case, [gloo_world[r][("rs",) + case]
                                                for r in range(2)], refs)
