"""Adasum in the port against the JAX package's.

- ``adasum_combine``'s properties, and the plain versions of the kernels
  (``ops/adasum.py``) against JAX ``_dots``/``adasum_combine``.
- The VHD core (``parallel/adasum.py`` ``vhd``) driven in one process by a
  lock-step exchange between n threads, one a simulated rank, against
  ``adasum_allreduce_hd`` in ``shard_map`` on n CPU devices; the tree
  against ``adasum_allreduce``; the two-level schedule bitwise the flat
  VHD.
- A 4-process gloo world through the port's launcher (two slices of two,
  ``--hierarchical-allreduce``): a grouped Adasum allreduce two-level and
  flat, with a bf16 wire, on a process set of 3 (the tree) and with a
  joined rank, against the JAX engine at world 4 (``HOROVOD_SLICE_MAP=2``,
  a subprocess with 4 CPU devices), and the Adasum outcome of every dtype.
- ``DistributedOptimizer(op=Adasum)``: two gloo processes against the JAX
  torch binding's under the JAX launcher.

Tolerances: float32 results within rtol 1e-5, atol 1e-6 of the JAX
functions (the same arithmetic, sums in another order), the engine runs
within rtol 1e-4, atol 1e-5 (the tree against the VHD rounds at other
places, as ``tests/test_parallel_primitives.py`` holds the JAX engine);
bf16 and fp16 results within one unit in the last place of their type.
Integer and bool inputs are orthogonal across ranks (disjoint supports),
so their Adasum is their exact sum and the comparison is exact.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import adasum as jad
from horovod_tpu_torch.ops import adasum as ak
from horovod_tpu_torch.parallel import adasum as pad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL = 4, 2
RTOL, ATOL = 1e-5, 1e-6
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
PIN = ("bool", "uint8", "int8", "int16", "int32", "float32", "bfloat16",
       "float16", "complex64")


def _vals(n, size, seed):
    return np.random.RandomState(seed).randn(n, size).astype(np.float32)


# ------------------------------------------------------ combine and kernels
def test_torch_adasum_combine_properties():
    """Orthogonal gradients add; identical gradients average (JAX
    ``test_adasum_properties``); a zero partner leaves a gradient as it is
    (a joined rank's contribution)."""
    a = torch.tensor([1.0, 0.0, 0.0])
    b = torch.tensor([0.0, 1.0, 0.0])
    np.testing.assert_allclose(pad.adasum_combine(a, b).numpy(),
                               [1.0, 1.0, 0.0], atol=1e-6)
    c = torch.tensor([2.0, 2.0, 0.0])
    np.testing.assert_allclose(pad.adasum_combine(c, c).numpy(), c.numpy(),
                               atol=1e-5)
    x = torch.from_numpy(_vals(1, 9, 1)[0])
    assert torch.equal(pad.adasum_combine(x, torch.zeros(9)), x)
    assert torch.equal(pad.adasum_combine(torch.zeros(9), x), x)


@pytest.mark.parametrize("n", [1, 17, 1000, 4097])
def test_torch_adasum_plain_kernels_match_jax(n):
    """``dots`` against JAX ``_dots`` (k·r to RTOL of |k|·|r|, the squares
    to RTOL); the combine from JAX's own triple bitwise-close to JAX's
    ``adasum_combine`` arithmetic; ``adasum_combine`` in float32 and in
    bf16 against JAX's."""
    a, b = _vals(2, n, n)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jab, jaa, jbb = (float(v) for v in jad._dots(ja, jb))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tri = ak.dots(ta, tb)
    assert abs(float(tri[0]) - jab) <= RTOL * np.sqrt(jaa * jbb)
    np.testing.assert_allclose([float(tri[1]), float(tri[2])], [jaa, jbb],
                               rtol=RTOL)
    # The combine given JAX's triple: the kernel's arithmetic is JAX's.
    jtri = torch.tensor([jab, jaa, jbb], dtype=torch.float32)
    ca = 1.0 - jnp.float32(jab) / (2.0 * jnp.float32(jaa) + 1e-30)
    cb = 1.0 - jnp.float32(jab) / (2.0 * jnp.float32(jbb) + 1e-30)
    want = np.asarray(ca * ja + cb * jb)
    np.testing.assert_allclose(ak.combine(ta, tb, jtri, True).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ak.combine(tb, ta, jtri, False).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        pad.adasum_combine(ta, tb).numpy(),
        np.asarray(jad.adasum_combine(ja, jb)), rtol=RTOL, atol=ATOL)
    bf = ml_dtypes.bfloat16
    got = pad.adasum_combine(ta.bfloat16(), tb.bfloat16()).float().numpy()
    ref = np.asarray(jad.adasum_combine(ja.astype(bf), jb.astype(bf)),
                     np.float32)
    np.testing.assert_allclose(got, ref, rtol=ULP["bfloat16"], atol=1e-6)


def test_torch_adasum_kernel_wrappers_check_their_inputs():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="float32"):
        ak.dots(x.double(), x.double())
    with pytest.raises(ValueError, match="one length"):
        ak.dots(x, torch.zeros(5))
    with pytest.raises(ValueError, match="triple"):
        ak.combine(x, x, torch.zeros(2), True)
    assert ak.dots.launches == 0 and ak.combine.launches == 0


# ------------------------------------------------------ VHD, simulated ranks
class _LockStep:
    """n threads, one a rank: ``swap(send, out, peer)`` posts ``send``,
    waits for every rank, takes the peer's tensor, waits again."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=30)
        self.box = {}

    def swap_for(self, rank, ranks):
        def swap(send, out, peer):
            self.box[(rank, ranks[peer])] = send.clone()
            self.barrier.wait()
            out.copy_(self.box.pop((ranks[peer], rank)))
            self.barrier.wait()
        return swap


def _run_ranks(n, body):
    outs, errs = [None] * n, []

    def run(r):
        try:
            outs[r] = body(r)
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errs.append(exc)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    return outs


def _vhd_flat(xs):
    n = len(xs)
    ls = _LockStep(n)
    return _run_ranks(n, lambda r: pad.adasum_allreduce_hd(
        xs[r], ls.swap_for(r, list(range(n))), r, n))


def _vhd_hier(xs, local):
    n, ls = len(xs), _LockStep(len(xs))
    cross = n // local

    def body(r):
        s, i = divmod(r, local)
        return pad.adasum_allreduce_hier(
            xs[r],
            (ls.swap_for(r, [s * local + j for j in range(local)]), i, local),
            (ls.swap_for(r, [c * local + i for c in range(cross)]), s, cross))
    return _run_ranks(n, body)


def _jax_over(n, fn, vals):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    return np.asarray(jax.jit(shard_map(
        lambda x: fn(x.reshape(-1))[None], mesh=mesh, in_specs=P("hvd"),
        out_specs=P("hvd"), check_vma=False))(jnp.asarray(vals)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_torch_vhd_matches_jax_hd(n):
    """Odd length (17): the padding path.  Every simulated rank ends with
    the same bits."""
    vals = _vals(n, 17, 7 + n)
    outs = _vhd_flat([torch.from_numpy(v) for v in vals])
    ref = _jax_over(n, lambda x: jad.adasum_allreduce_hd(x, axis_name="hvd"),
                    vals)
    for r in range(n):
        assert torch.equal(outs[r], outs[0])
        np.testing.assert_allclose(outs[r].numpy(), ref[r], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n", [3, 5, 6])
def test_torch_tree_matches_jax(n):
    """Sizes that are no power of two gather and reduce by the tree, an
    odd remainder folded into the level's last pair."""
    vals = _vals(n, 11, 20 + n)
    ts = [torch.from_numpy(v) for v in vals]
    got = pad.adasum_allreduce(ts[0], lambda x: ts)
    ref = _jax_over(n, lambda x: jad.adasum_allreduce(x, "hvd"), vals)
    for r in range(n):
        np.testing.assert_allclose(got.numpy(), ref[r], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slices,local", [(2, 2), (2, 4), (4, 2)])
def test_torch_two_level_vhd_is_the_flat_vhd(slices, local):
    """Local rounds, then cross rounds, over host-major ranks: the flat
    identity-order schedule, so the bits are the flat VHD's."""
    n = slices * local
    xs = [torch.from_numpy(v) for v in _vals(n, 29, 40 + n)]
    flat, hier = _vhd_flat(xs), _vhd_hier(xs, local)
    for a, b in zip(flat, hier):
        assert torch.equal(a, b)


def test_torch_vhd_refuses_non_power_of_two():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="power of two"):
        pad.adasum_allreduce_hd(x, None, 0, 3)
    with pytest.raises(ValueError, match="local extent"):
        pad.adasum_allreduce_hier(x, (None, 0, 3), (None, 0, 2))


# ------------------------------------------------------------- engine runs
def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _pin_input(name, rank, n=16):
    """Floats random; integers and bools on the positions ``i % WORLD ==
    rank`` only, so the ranks' vectors are orthogonal."""
    rng = np.random.RandomState(900 + 13 * rank + PIN.index(name))
    if name == "complex64":
        return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    if name in ("float32", "bfloat16", "float16"):
        return rng.randn(n).astype(_np_dtype(name))
    mask = np.arange(n) % WORLD == rank
    if name == "bool":
        return mask & (rng.randint(0, 2, n) == 1)
    return (mask * rng.randint(1, 4, n)).astype(name)


def _inputs(rank):
    rng = np.random.RandomState(700 + rank)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "group": [f32(33), f32(4, 5).astype(ml_dtypes.bfloat16), f32(1)],
        "wire": [f32(40), f32(3, 3)],
        "tree": [f32(21), f32(2, 2)],
        "join": [f32(10), f32(6)],
        "pin": {name: _pin_input(name, rank) for name in PIN},
    }


_PORT = textwrap.dedent("""
    import pickle, sys
    import ml_dtypes, numpy as np, torch
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.common.basics._get_state().engine
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)[r]

    def T(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    def N(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def grouped(key, **kw):
        return [N(t) for t in eager.grouped_allreduce(
            [T(a) for a in ins[key]], op=hvd.Adasum, **kw)]

    out = {}
    d0 = eng.hier_dispatches
    out["group"] = (grouped("group", name="gh"),
                    grouped("group", name="gf", hierarchical=False))
    out["wire"] = (grouped("wire", name="wh", compression="bf16"),
                   grouped("wire", name="wf", compression="bf16",
                           hierarchical=False))
    out["hier_dispatches"] = eng.hier_dispatches - d0
    for name, x in ins["pin"].items():
        try:
            res = eager.allreduce(T(x), name=f"pin.{name}", op=hvd.Adasum)
            out[("pin", name)] = N(res)
        except Exception as exc:
            out[("pin", name)] = ("raises", type(exc).__name__)
    try:
        hvd.reducescatter(T(ins["pin"]["float32"]), op=hvd.Adasum)
        out["scatter"] = "returned"
    except ValueError as exc:
        out["scatter"] = str(exc)
    ps = hvd.add_process_set([0, 1, 2])
    if r < 3:
        out["tree"] = grouped("tree", name="t", process_set=ps)
    hvd.remove_process_set(ps)
    if r < 3:
        out["join"] = grouped("join", name="j")
    out["last_joined"] = hvd.join()
    hvd.shutdown()
    with open(sys.argv[3] + f".{r}", "wb") as fh:
        pickle.dump(out, fh)
    print("ADASUM_OK", r)
""")

_JAX = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu as hvd
    hvd.init()
    assert hvd.size() == 4
    with open(sys.argv[2], "rb") as fh:
        ins = pickle.load(fh)

    def stacked(key, k, ranks=range(4), ps=None):
        vals = [ins[r][key][k] for r in ranks]
        return hvd.stack_per_rank(vals, ps) if ps else \\
            hvd.stack_per_rank(vals)

    def grouped(key, ps=None, ranks=range(4), **kw):
        n = len(ins[0][key])
        return [np.asarray(o) for o in hvd.grouped_allreduce(
            [stacked(key, k, ranks, ps) for k in range(n)], op=hvd.Adasum,
            process_set=ps, **kw)]

    out = {"group": grouped("group", name="gh"),
           "group_flat": grouped("group", name="gf", hierarchical=False),
           "wire": grouped("wire", name="w", compression="bf16")}
    for name in ins[0]["pin"]:
        try:
            out[("pin", name)] = np.asarray(hvd.allreduce(
                hvd.stack_per_rank([i["pin"][name] for i in ins]),
                name=f"pin.{name}", op=hvd.Adasum))
        except Exception as exc:
            out[("pin", name)] = ("raises", type(exc).__name__)
    ps = hvd.add_process_set([0, 1, 2])
    out["tree"] = grouped("tree", ps=ps, ranks=range(3), name="t")
    hvd.remove_process_set(ps)
    for i in ins:
        i["join0"] = [np.zeros_like(a) for a in i["join"]]
    out["join"] = [np.asarray(o) for o in hvd.grouped_allreduce(
        [hvd.stack_per_rank([ins[r]["join"][k] for r in range(3)]
                            + [ins[3]["join0"][k]])
         for k in range(2)], name="j", op=hvd.Adasum)]
    with open(sys.argv[3], "wb") as fh:
        pickle.dump(out, fh)
    print("JAX_OK")
""")

# The JAX torch binding under the JAX launcher, and the port's under its
# own: the same model, batches and steps.  One parameter (the bias a row of
# the weight, against a column of ones): how the hooks' allreduces fuse
# depends on when each gradient arrives, and Adasum's coefficients on the
# fused buffer, so one gradient a step keeps both engines' batches alike.
_OPT = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, sys.argv[1])
    port = sys.argv[3] == "port"
    if not port:
        os.environ["XLA_FLAGS"] = " ".join(
            f for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f)
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        import horovod_tpu.torch as hvd
    import numpy as np, torch
    if port:
        import horovod_tpu_torch as hvd
    hvd.init(**({"device": "cpu"} if port else {}))
    r = hvd.rank()
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(7, 3).astype(np.float32)) \\
        .requires_grad_()
    data = np.random.RandomState(50 + r)
    x = torch.from_numpy(np.concatenate(
        [data.randn(8, 6), np.ones((8, 1))], 1).astype(np.float32))
    y = torch.from_numpy(data.randn(8, 3).astype(np.float32))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   named_parameters=[("w", w)],
                                   op=hvd.Adasum)
    steps = []
    for _ in range(3):
        opt.zero_grad()
        loss = ((x @ w - y) ** 2).mean()
        loss.backward()
        opt.step()
        steps.append((float(loss), w.detach().numpy().copy()))
    hvd.shutdown()
    with open(sys.argv[2] + f".{sys.argv[3]}.{r}", "wb") as fh:
        pickle.dump(steps, fh)
    print("OPT_OK", r)
""")


def _clean_env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_", "HVD_TPU_"))}


def _jax_env():
    env = _clean_env()
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env.update(XLA_FLAGS=" ".join(
        flags + [f"--xla_force_host_platform_device_count={WORLD}"]),
        JAX_PLATFORMS="cpu", HOROVOD_SLICE_MAP=str(LOCAL),
        HOROVOD_HIERARCHICAL_ALLREDUCE="1")
    return env


def _logs(tmp, name, n):
    text = ""
    for r in range(n):
        for f in ("stdout", "stderr"):
            p = tmp / name / f"rank.{r}" / f
            if p.exists():
                text += p.read_text()[-2000:]
    return text


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Side by side: the port's gloo world of 4, the JAX engine at world 4,
    and the optimizer on two processes under each package's launcher."""
    tmp = tmp_path_factory.mktemp("adasum")
    with open(tmp / "ins.pkl", "wb") as fh:
        pickle.dump([_inputs(r) for r in range(WORLD)], fh)
    for name, src in (("port.py", _PORT), ("jax_ref.py", _JAX),
                      ("opt.py", _OPT)):
        (tmp / name).write_text(src)
    env = dict(_clean_env(), PYTHONPATH=REPO,
               HOROVOD_HIERARCHICAL_LOCAL_SIZE=str(LOCAL))
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(WORLD), "--hierarchical-allreduce", "--output-filename",
             str(tmp / "port_logs"), sys.executable, str(tmp / "port.py"),
             REPO, str(tmp / "ins.pkl"), str(tmp / "out")], env=env,
            cwd=str(tmp)),
        "jax": subprocess.Popen(
            [sys.executable, str(tmp / "jax_ref.py"), REPO,
             str(tmp / "ins.pkl"), str(tmp / "jax.pkl")], env=_jax_env(),
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "opt_port": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
             "--output-filename", str(tmp / "opt_port_logs"),
             sys.executable, str(tmp / "opt.py"), REPO, str(tmp / "opt"),
             "port"], env=dict(_clean_env(), PYTHONPATH=REPO),
            cwd=str(tmp)),
        "opt_jax": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu.runner.launch", "-np", "2",
             "--output-filename", str(tmp / "opt_jax_logs"),
             sys.executable, str(tmp / "opt.py"), REPO, str(tmp / "opt"),
             "jax"],
            env=dict(_clean_env(), PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
            cwd=str(tmp)),
    }
    try:
        rcs = {k: p.wait(timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    assert rcs["port"] == 0, _logs(tmp, "port_logs", WORLD)
    assert rcs["jax"] == 0, procs["jax"].stdout.read()
    assert rcs["opt_port"] == 0, _logs(tmp, "opt_port_logs", 2)
    assert rcs["opt_jax"] == 0, _logs(tmp, "opt_jax_logs", 2)
    port_out = []
    for r in range(WORLD):
        with open(tmp / f"out.{r}", "rb") as fh:
            port_out.append(pickle.load(fh))
    with open(tmp / "jax.pkl", "rb") as fh:
        jax_out = pickle.load(fh)
    opt = {}
    for who in ("port", "jax"):
        for r in range(2):
            with open(tmp / f"opt.{who}.{r}", "rb") as fh:
                opt[(who, r)] = pickle.load(fh)
    return port_out, jax_out, opt


def _close(got, want, dtype=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.dtype, got.shape, want.dtype, want.shape)
    name = dtype or got.dtype.name
    rtol = ULP.get(name, ENGINE_RTOL)
    np.testing.assert_allclose(got.astype(np.complex128
                                          if got.dtype.kind == "c"
                                          else np.float64),
                               want.astype(np.complex128
                                           if want.dtype.kind == "c"
                                           else np.float64),
                               rtol=rtol, atol=ENGINE_ATOL)


def test_torch_engine_adasum_two_level_is_flat_and_matches_jax(worlds):
    """A grouped fp32 + bf16 + one-element Adasum: the two-level VHD
    bitwise the flat VHD on every rank, the same bits on every rank, and
    within the stated tolerance of the JAX engine's two-level and flat
    results."""
    port, jax_out, _ = worlds
    for out in port:
        h, f = out["group"]
        assert out["hier_dispatches"] == 2       # the group, the wire
        for a, b, c, ref, jf in zip(h, f, port[0]["group"][0],
                                    jax_out["group"], jax_out["group_flat"]):
            assert a.tobytes() == b.tobytes() == c.tobytes()
            _close(a, ref)
            _close(a, jf)


def test_torch_engine_adasum_with_a_bf16_wire(worlds):
    """Compression bf16: the pack's cast to the wire, the VHD in float32,
    the cast back to the wire, the unpack's cast to float32 — the JAX
    program's roundings, so within one bf16 unit of its result."""
    port, jax_out, _ = worlds
    for out in port:
        h, f = out["wire"]
        for a, b, ref in zip(h, f, jax_out["wire"]):
            assert a.tobytes() == b.tobytes() and a.dtype == np.float32
            _close(a, ref, "bfloat16")


def test_torch_engine_adasum_tree_on_a_set_of_three(worlds):
    port, jax_out, _ = worlds
    for out in port[:3]:
        for a, b, ref in zip(out["tree"], port[0]["tree"], jax_out["tree"]):
            assert a.tobytes() == b.tobytes()
            _close(a, ref)


def test_torch_engine_adasum_with_a_joined_rank(worlds):
    """Rank 3 joins at once: its part is zeros (``adasum(a, 0) = a``), as
    the JAX engine's ``_join_fill_value`` gives Adasum."""
    port, jax_out, _ = worlds
    for out in port[:3]:
        for a, b, ref in zip(out["join"], port[0]["join"], jax_out["join"]):
            assert a.tobytes() == b.tobytes()
            _close(a, ref)
    assert all(out["last_joined"] == port[0]["last_joined"] for out in port)


@pytest.mark.parametrize("name", PIN)
def test_torch_adasum_dtype_pin(worlds, name):
    """Each dtype's Adasum outcome against the JAX engine's: "agrees" (its
    dtype, and values within the tolerance: exact for the orthogonal
    integers and bools) or "both raise".  Every dtype keeps its own, as the
    JAX ``_vhd`` casts to float32 and back; a complex tensor keeps its
    real part.  A reducescatter refuses Adasum, as the JAX engine's."""
    port, jax_out, _ = worlds
    ref = jax_out[("pin", name)]
    for out in port:
        got = out[("pin", name)]
        if isinstance(ref, tuple):
            assert isinstance(got, tuple), (name, got, ref)
            continue
        assert not isinstance(got, tuple), (name, got, ref)
        if np.asarray(got).dtype.kind in "biu":
            assert np.asarray(got).dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        else:
            _close(got, ref, name)
        assert got.tobytes() == port[0][("pin", name)].tobytes()
    assert "does not support ReduceOp ADASUM" in port[0]["scatter"]


def test_torch_distributed_optimizer_adasum_matches_jax_binding(worlds):
    """``DistributedOptimizer(SGD, op=Adasum)`` on two gloo processes:
    the losses and parameters of 3 steps against the JAX torch binding's
    under the JAX launcher, on both ranks, and equal across the port's
    ranks bitwise."""
    _, _, opt = worlds
    for r in range(2):
        for (pl, pw), (jl, jw) in zip(opt[("port", r)], opt[("jax", r)]):
            np.testing.assert_allclose(pl, jl, rtol=ENGINE_RTOL)
            np.testing.assert_allclose(pw, jw, rtol=ENGINE_RTOL,
                                       atol=ENGINE_ATOL)
    for (_, w0), (_, w1) in zip(opt[("port", 0)], opt[("port", 1)]):
        assert w0.tobytes() == w1.tobytes()


def test_torch_distributed_optimizer_adasum_refuses_predivide():
    import horovod_tpu_torch as hvd
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="not supported"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 op=hvd.Adasum,
                                 gradient_predivide_factor=2.0)
