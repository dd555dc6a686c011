"""Port parity: the TensorFlow and Keras bindings over the port's engine.

``horovod_tpu_torch.tensorflow`` and ``.keras`` against
``horovod_tpu.tensorflow`` and ``.keras`` on the same inputs: the twelve
cases of ``tests/test_tensorflow.py`` with the port at size 1 (a CPU world)
and the JAX binding in its 8-rank single-controller harness, where Sum
multiplies by 8 and Average is the identity up to float32 rounding (the
JAX world sums eight copies and scales by the reciprocal): integer-valued
results are held to the JAX ones exactly (Sum divided by 8 first), others
within rtol 1e-6; each dtype through the DLPack bridge, exactly;
``backward_passes_per_step`` aggregation equal to the JAX binding's on the
same gradients within rtol 1e-6; the refusals (a
collective inside a trace, a Keras backend other than TensorFlow); and
the multi-process case of ``tests/test_multiprocess.py::
test_torovodrun_tensorflow_keras`` with its worker written from this file,
through ``python -m horovod_tpu_torch.runner -np 2`` on gloo.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

import horovod_tpu_torch as thvd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def jtf(hvd):
    import horovod_tpu.tensorflow as jtf
    return jtf


@pytest.fixture()
def ttf():
    thvd.init(device="cpu")
    import horovod_tpu_torch.tensorflow as ttf
    return ttf


def _same(got, want, dtype=None):
    assert isinstance(got, tf.Tensor)
    assert got.dtype == (dtype or want.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_tf_allreduce_matches_jax(jtf, ttf):
    w = jtf.size()
    t = tf.constant([1.0, 2.0, 3.0])
    want = jtf.allreduce(t, name="tf_ar", op=jtf.Sum)
    got = ttf.allreduce(t, name="tf_ar", op=ttf.Sum)
    assert ttf.size() == 1
    _same(got * w, want)
    want = jtf.allreduce(t, name="tf_ar_avg", op=jtf.Average)
    _same(ttf.allreduce(t, name="tf_ar_avg", op=ttf.Average), want)
    # Factors apply at size 1 too.
    got = ttf.allreduce(t, name="tf_ar_f", op=ttf.Sum, prescale_factor=2.0,
                        postscale_factor=0.25)
    _same(got, t.numpy() * 0.5, tf.float32)


def test_torch_tf_allreduce_compression_fp16(jtf, ttf):
    t = tf.constant(np.linspace(-2, 2, 8, dtype=np.float32))
    want = jtf.allreduce(t, name="tf_ar_c", op=jtf.Average,
                         compression=jtf.Compression.fp16)
    for comp in (ttf.Compression.fp16, ttf.Compression.bf16):
        got = ttf.allreduce(t, name="tf_ar_c", op=ttf.Average,
                            compression=comp)
        assert got.dtype == tf.float32
        np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=2e-3 if
                                   comp is ttf.Compression.fp16 else 8e-3)
    # At size 1 the average is the fp16 cast and back; the JAX world sums
    # eight fp16 copies first, so it is held within fp16's rounding.
    got = ttf.allreduce(t, name="tf_ar_c", op=ttf.Average,
                        compression=ttf.Compression.fp16)
    _same(got, t.numpy().astype(np.float16).astype(np.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3)


def test_torch_tf_grouped_allreduce(jtf, ttf):
    w = jtf.size()
    ins = [tf.ones([2, 3]), tf.constant([4.0, 5.0])]
    want = jtf.grouped_allreduce(ins, name="tf_grp", op=jtf.Sum)
    got = ttf.grouped_allreduce(ins, name="tf_grp", op=ttf.Sum)
    for g, j in zip(got, want):
        _same(g * w, j)


def test_torch_tf_allgather_broadcast(jtf, ttf):
    w = jtf.size()
    x = tf.reshape(tf.range(6, dtype=tf.float32), (2, 3))
    want = jtf.allgather(x, name="tf_ag")
    got = ttf.allgather(x, name="tf_ag")
    assert want.shape == (2 * w, 3) and got.shape == (2, 3)
    _same(got, want.numpy()[:2])
    want = jtf.broadcast(tf.constant([7.0, 8.0]), root_rank=0, name="tf_bc")
    got = ttf.broadcast(tf.Variable([7.0, 8.0]), root_rank=0, name="tf_bc")
    _same(got, want)


def test_torch_tf_alltoall_even_and_ragged(jtf, ttf):
    t = tf.reshape(tf.range(2, dtype=tf.float32), (1, 2))
    _same(ttf.alltoall(t, name="tf_a2a"), t.numpy())
    with pytest.raises(ValueError, match="divisible"):
        ttf.alltoall(tf.constant(1.0), name="tf_a2a_bad")
    tr = tf.reshape(tf.range(3, dtype=tf.float32), (3, 1))
    out, rsp = ttf.alltoall(tr, splits=tf.constant([3]), name="tf_a2av")
    assert rsp.numpy().tolist() == [3]
    _same(out, tr.numpy())
    # The JAX binding's ragged result for rank 0 of its world, on rank 0's
    # chunk alone, is the port's at size 1 on that chunk.
    w = jtf.size()
    splits = tf.constant([j + 1 for j in range(w)])
    n = int(sum(j + 1 for j in range(w)))
    jr = tf.reshape(tf.range(n, dtype=tf.float32), (n, 1))
    jout, jrsp = jtf.alltoall(jr, splits=splits, name="tf_a2av")
    assert jrsp.numpy().tolist() == [1] * w
    got, grsp = ttf.alltoall(jr[:1], splits=[1], name="tf_a2av1")
    _same(got, jout.numpy()[:1])
    assert grsp.dtype == jrsp.dtype == tf.int64


def test_torch_tf_reducescatter(jtf, ttf):
    w = jtf.size()
    want = jtf.reducescatter(tf.ones([2 * w, 3]), name="tf_rs", op=jtf.Sum)
    got = ttf.reducescatter(tf.ones([2, 3]), name="tf_rs", op=ttf.Sum)
    _same(got * w, want)
    got = ttf.reducescatter(tf.ones([2, 3]), name="tf_rs_avg",
                            op=ttf.Average)
    _same(got, np.ones((2, 3), np.float32))


def test_torch_tf_distributed_gradient_tape(jtf, ttf):
    grads = []
    for mod in (jtf, ttf):
        x = tf.Variable([1.0, 2.0])
        y = tf.Variable([3.0])
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(x * x)
        tape = mod.DistributedGradientTape(tape)
        grads.append(tape.gradient(loss, [x, y]))
    (jg, jnone), (tg, tnone) = grads
    assert jnone is None and tnone is None
    _same(tg, jg)
    np.testing.assert_array_equal(tg.numpy(), [2.0, 4.0])


def test_torch_tf_distributed_optimizer_apply(jtf, ttf):
    opt = ttf.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5))
    assert isinstance(opt, keras.optimizers.SGD)  # dynamic subclass
    assert type(opt).__name__ == "SGD"
    jopt = jtf.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5))
    v, jv = tf.Variable([1.0, 1.0]), tf.Variable([1.0, 1.0])
    opt.apply_gradients([(tf.constant([0.2, 0.4]), v)])
    jopt.apply_gradients([(tf.constant([0.2, 0.4]), jv)])
    assert v.dtype == jv.dtype
    np.testing.assert_allclose(v.numpy(), jv.numpy(), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), [0.9, 0.8], rtol=1e-6)


def _bpps_run(mod, grads, bpps):
    opt = mod.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5),
                                   backward_passes_per_step=bpps)
    v = tf.Variable([1.0, -1.0])
    seen = []
    for g in grads:
        opt.apply_gradients([(g, v)])
        seen.append(v.numpy().copy())
    return seen


def test_torch_tf_distributed_optimizer_bpps_matches_jax(jtf, ttf):
    """backward_passes_per_step=2: the first apply touches no weight; the
    second applies the micro-batch average, exactly as the JAX binding
    does on the same gradients, and as one bpps=1 step on the pre-averaged
    gradient; the second window behaves the same (buffers reset)."""
    rng = np.random.RandomState(3)
    grads = [tf.constant(rng.randn(2).astype(np.float32)) for _ in range(4)]
    got = _bpps_run(ttf, grads, 2)
    want = _bpps_run(jtf, grads, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_array_equal(got[0], [1.0, -1.0])
    one = _bpps_run(ttf, [(grads[0] + grads[1]) / 2.0,
                          (grads[2] + grads[3]) / 2.0], 1)
    np.testing.assert_allclose(got[1], one[0], rtol=1e-6)
    np.testing.assert_allclose(got[3], one[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], got[1])


def test_torch_tf_distributed_optimizer_bpps_none_grads_skip_var(ttf):
    opt = ttf.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.5), backward_passes_per_step=2)
    live = tf.Variable([1.0])
    frozen = tf.Variable([2.0])
    g = tf.constant([0.2])
    opt.apply_gradients([(g, live), (None, frozen)])
    opt.apply_gradients([(g, live), (None, frozen)])
    np.testing.assert_allclose(live.numpy(), [0.9], rtol=1e-6)
    np.testing.assert_array_equal(frozen.numpy(), [2.0])   # never touched


def test_torch_tf_broadcast_variables(jtf, ttf):
    vs = [tf.Variable([5.0, 6.0]), tf.Variable([[1, 2]], dtype=tf.int32),
          tf.Variable([True, False])]
    js = [tf.Variable(v.numpy()) for v in vs]
    ttf.broadcast_variables(vs, root_rank=0)
    jtf.broadcast_variables(js, root_rank=0)
    for v, j in zip(vs, js):
        _same(v.value(), j.numpy(), j.dtype)
    ttf.broadcast_variables([])


DTYPES = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
          "int32", "int64", "uint8", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_tf_bridge_dtypes(jtf, ttf, dtype):
    """Each dtype through DLPack and back: the dtype kept, the values
    exact, the same as the JAX binding's broadcast and allgather; a Sum of
    bool (int32 in the engine) cast back to bool as JAX's binding does."""
    dt = tf.as_dtype(dtype)
    x = tf.cast(tf.constant([[0, 1, 3], [5, 0, 2]]), dt)
    t, got_dt = __import__(
        "horovod_tpu_torch.tensorflow.mpi_ops", fromlist=["_to_torch"]
    )._to_torch(x)
    assert got_dt == dt and str(t.dtype) == f"torch.{dtype}"
    _same(ttf.broadcast(x, name=f"dt_bc_{dtype}"),
          jtf.broadcast(x, name=f"dt_bc_{dtype}").numpy(), dt)
    _same(ttf.allgather(x, name=f"dt_ag_{dtype}"), x.numpy(), dt)
    op = ttf.Max if dtype == "bool" else ttf.Sum
    _same(ttf.allreduce(x, name=f"dt_ar_{dtype}", op=op), x.numpy(), dt)
    v = tf.Variable(x)
    _same(ttf.allreduce(v, name=f"dt_arv_{dtype}", op=op), x.numpy(), dt)


def test_torch_tf_refuses_inside_a_trace(ttf):
    @tf.function
    def traced(x):
        return ttf.allreduce(x, name="traced")

    with pytest.raises(RuntimeError, match="graph_safe"):
        traced(tf.constant([1.0]))
    safe = tf.function(lambda x: ttf.graph_safe(
        lambda a: ttf.allreduce(a, name="safe", op=ttf.Sum))(x))
    np.testing.assert_array_equal(safe(tf.constant([1.5])).numpy(), [1.5])


def test_torch_keras_refuses_another_backend():
    src = ("import os, sys\n"
           "os.environ['KERAS_BACKEND'] = 'numpy'\n"
           "sys.path.insert(0, sys.argv[1])\n"
           "try:\n"
           "    import horovod_tpu_torch.keras\n"
           "except ImportError as exc:\n"
           "    print('REFUSED', exc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", src, REPO],
                         capture_output=True, text=True, env=env, timeout=180)
    assert "REFUSED" in res.stdout and "'numpy'" in res.stdout, (
        res.stdout[-2000:] + res.stderr[-2000:])


def test_torch_keras_fit_end_to_end(jtf, ttf):
    """Keras model.fit with the port's optimizer + callbacks: the compiled
    train step reduces via py_function; the losses and weights equal the
    JAX binding's on the same data and initial weights (its world of 8
    averages 8 equal gradients, exactly the port's one), the loss
    decreases, and warmup ends at initial_lr * size()."""
    import horovod_tpu.keras as jk
    import horovod_tpu_torch.keras as tk
    from horovod_tpu.keras import callbacks as jkcb
    from horovod_tpu_torch.keras import callbacks as tkcb

    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    true_w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    y = X @ true_w + 0.01 * rng.randn(64, 1).astype(np.float32)
    init = rng.randn(4, 1).astype(np.float32)
    runs = []
    for k, kcb, lr_end in ((jk, jkcb, 0.05 * jtf.size()),
                           (tk, tkcb, 0.05 * ttf.size())):
        model = keras.Sequential([keras.layers.Input((4,)),
                                  keras.layers.Dense(1, use_bias=False)])
        model.set_weights([init])
        opt = k.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.05))
        model.compile(optimizer=opt, loss="mse")
        hist = model.fit(
            X, y, batch_size=16, epochs=3, verbose=0, shuffle=False,
            callbacks=[kcb.BroadcastGlobalVariablesCallback(0),
                       kcb.MetricAverageCallback(),
                       kcb.LearningRateWarmupCallback(
                           initial_lr=0.05, warmup_epochs=2,
                           momentum_correction=False)])
        losses = hist.history["loss"]
        assert losses[-1] < losses[0] * 0.5, losses
        final_lr = float(model.optimizer.learning_rate.numpy())
        assert final_lr == pytest.approx(lr_end, rel=1e-5)
        runs.append((losses, model.get_weights()[0]))
    with pytest.warns(UserWarning, match="momentum_correction"):
        tkcb.LearningRateWarmupCallback(0.1)
    # With one rank (the port) the warmup keeps lr at 0.05 throughout;
    # the JAX world of 8 warms up to 0.4: the first epoch's lr differs
    # (0.05 against 0.2), so only the port's run against a plain fit.
    plain = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(1, use_bias=False)])
    plain.set_weights([init])
    plain.compile(optimizer=keras.optimizers.SGD(learning_rate=0.05),
                  loss="mse")
    ref = plain.fit(X, y, batch_size=16, epochs=3, verbose=0, shuffle=False)
    np.testing.assert_allclose(runs[1][0], ref.history["loss"], rtol=1e-6)
    np.testing.assert_allclose(runs[1][1], plain.get_weights()[0],
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------- two ranks over gloo
_WORKER = textwrap.dedent("""
    import os, sys
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    import numpy as np
    import tensorflow as tf
    import keras

    import horovod_tpu_torch.tensorflow as hvd
    import horovod_tpu_torch.keras as khvd
    from horovod_tpu_torch.keras import callbacks as kcb

    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()

    # Rank-dependent allreduce through the TF surface.
    t = tf.constant([1.0, 2.0]) * float(rank + 1)
    out = hvd.allreduce(t, name="tf_ar", op=hvd.Sum)
    scale = sum(r + 1 for r in range(size))
    np.testing.assert_array_equal(out.numpy(), np.array([1.0, 2.0]) * scale)

    # Rank-dependent gather, scatter and exchange.
    g = hvd.allgather(tf.fill([2, 2], rank), name="tf_ag")
    assert g.numpy().tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]], g
    rs = hvd.reducescatter(tf.reshape(tf.range(4.0), (2, 2)) * (rank + 1),
                           name="tf_rs", op=hvd.Sum)
    np.testing.assert_array_equal(rs.numpy(), [[0.0, 3.0], [6.0, 9.0]][rank:
                                  rank + 1])
    a2a = hvd.alltoall(tf.constant([[10 * rank], [10 * rank + 1]]),
                       name="tf_a2a")
    assert a2a.numpy().ravel().tolist() == [rank, 10 + rank], a2a
    rows = tf.reshape(tf.range(3.0) + 100 * rank, (3, 1))
    out, rsp = hvd.alltoall(rows, splits=[1, 2] if rank == 0 else [2, 1],
                            name="tf_a2av")
    assert rsp.numpy().tolist() == ([1, 2] if rank == 0 else [2, 1]), rsp
    want = [[0.0], [100.0], [101.0]] if rank == 0 else [[1.0], [2.0],
                                                        [102.0]]
    np.testing.assert_array_equal(out.numpy(), want)
    assert hvd.allgather_object({"r": rank}) == [{"r": 0}, {"r": 1}]

    # DistributedGradientTape: grads averaged across ranks.
    x = tf.Variable([1.0, 2.0])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(x * x) * float(rank + 1)
    tape = hvd.DistributedGradientTape(tape)
    (grad,) = tape.gradient(loss, [x])
    expected = np.array([2.0, 4.0]) * np.mean([r + 1 for r in range(size)])
    np.testing.assert_allclose(grad.numpy(), expected, rtol=1e-6)

    # broadcast_variables: everyone ends with rank 0's values.
    v = tf.Variable(np.full((3,), float(rank + 10), np.float32))
    hvd.broadcast_variables([v], root_rank=0)
    np.testing.assert_array_equal(v.numpy(), np.full((3,), 10.0))

    # backward_passes_per_step=2 with rank-dependent micro-grads equals one
    # bpps=1 step on the locally pre-averaged gradient.
    va = tf.Variable([1.0, -1.0])
    vb = tf.Variable([1.0, -1.0])
    opt2 = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5),
                                    backward_passes_per_step=2)
    opt1 = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5))
    g1 = tf.constant([0.1, 0.2]) * float(rank + 1)
    g2 = tf.constant([0.3, -0.1]) * float(rank + 1)
    opt2.apply_gradients([(g1, va)])
    np.testing.assert_array_equal(va.numpy(), [1.0, -1.0])
    opt2.apply_gradients([(g2, va)])
    opt1.apply_gradients([((g1 + g2) / 2.0, vb)])
    np.testing.assert_allclose(va.numpy(), vb.numpy(), rtol=1e-6)

    # An mnist-style Keras fit: per-rank data, another init per rank, the
    # distributed optimizer and the callbacks; ranks end bit-identical.
    rng = np.random.RandomState(100 + rank)
    X = rng.randn(128, 8).astype(np.float32)
    y = (X.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    keras.utils.set_random_seed(rank + 1)
    model = keras.Sequential([
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(1, activation="sigmoid"),
    ])
    opt = khvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1))
    model.compile(optimizer=opt, loss="binary_crossentropy")
    hist = model.fit(X, y, batch_size=32, epochs=2, verbose=0, shuffle=False,
                     callbacks=[kcb.BroadcastGlobalVariablesCallback(0),
                                kcb.MetricAverageCallback(),
                                kcb.LearningRateWarmupCallback(
                                    0.1, warmup_epochs=2,
                                    momentum_correction=False)])
    assert len(hist.history["loss"]) == 2
    losses = hvd.allgather_object(hist.history["loss"])
    assert losses[0] == losses[1], losses
    lr = float(model.optimizer.learning_rate.numpy())
    assert abs(lr - 0.1 * size) < 1e-7, lr
    flat = np.concatenate([w.numpy().ravel() for w in model.weights])
    gathered = hvd.allgather(tf.constant(flat[None]), name="wflat").numpy()
    np.testing.assert_array_equal(gathered[0], gathered[1],
                                  err_msg="ranks diverged after fit")
    print(f"TF_OK rank={rank}")
    hvd.shutdown()
""")


def test_torch_runner_tensorflow_keras(tmp_path):
    """The TF/Keras binding across two processes of the port's launcher:
    rank-dependent collectives, tape averaging, broadcast_variables, bpps
    aggregation, and a Keras fit that leaves the ranks bit-identical."""
    script = tmp_path / "worker_tf.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=420)
    assert res.returncode == 0 and res.stdout.count("TF_OK") == 2, (
        f"rc={res.returncode}\nstdout:\n{res.stdout[-3000:]}\n"
        f"stderr:\n{res.stderr[-3000:]}")
