"""Port parity: the Spark and Ray integrations over the port's launcher
and elastic driver.

``horovod_tpu_torch.spark`` and ``.ray`` against ``horovod_tpu.spark`` and
``.ray``, runnable without ray or pyspark (neither is installed): the
counterparts of the cases of ``tests/test_ray_spark.py`` on the same kind
of fakes.  The placement strategies, the stores, the materialization and
the deterministic ports equal the JAX package's exactly; a Ray actor's
and a Spark task's env equal the env the port's launcher gives the worker
of that rank (``runner/run.py`` ``worker_envs``), and hold the JAX ones'
``HOROVOD_*`` values; the Torch and Keras estimators fit and transform
through the port at size 1 in a CPU world, their trained weights within
1e-5 of the JAX package's estimators on the same rows and seed (whose
8-rank single-controller world averages eight equal gradients); the Ray
elastic executor, on a fake cluster, re-forms the world after an actor's
death and moves the controller off a dead host 0, with each actor's env
the port's elastic worker's.
"""

import os

import numpy as np
import pytest

import horovod_tpu_torch as thvd
from horovod_tpu import ray as jray
from horovod_tpu import spark as jspark
from horovod_tpu.spark import estimator as jest
from horovod_tpu_torch.ray import NodeResources, RayExecutor, pack, spread
from horovod_tpu_torch.spark import LocalStore, Store
from horovod_tpu_torch.spark import estimator as test_

NODES = [NodeResources("a", cpus=8, accelerators=4),
         NodeResources("b", cpus=8, accelerators=4),
         NodeResources("c", cpus=8, accelerators=2)]
JNODES = [jray.NodeResources(n.hostname, n.cpus, n.accelerators)
          for n in NODES]


def _allocs(allocs):
    return [(a.hostname, a.local_rank, a.rank, a.cross_rank) for a in allocs]


def _launcher_env(rank, hosts, np_, coord):
    """The env the port's launcher gives rank ``rank``."""
    from horovod_tpu_torch.runner.run import (HostSpec, parse_args,
                                              worker_envs)
    args = parse_args(["-np", str(np_), "cmd"])
    specs = [HostSpec(h, s) for h, s in hosts]
    return worker_envs(args, specs, coord)[rank]


def test_torch_pack_fills_nodes_in_order():
    allocs = pack(NODES, 6)
    assert [(a.hostname, a.local_rank, a.rank) for a in allocs] == [
        ("a", 0, 0), ("a", 1, 1), ("a", 2, 2), ("a", 3, 3),
        ("b", 0, 4), ("b", 1, 5)]
    assert allocs[4].cross_rank == 1
    assert _allocs(allocs) == _allocs(jray.pack(JNODES, 6))


def test_torch_spread_round_robins():
    allocs = spread(NODES, 6)
    by_host = {}
    for a in allocs:
        by_host[a.hostname] = by_host.get(a.hostname, 0) + 1
    assert by_host == {"a": 2, "b": 2, "c": 2}
    assert [a.hostname for a in allocs] == ["a", "a", "b", "b", "c", "c"]
    assert _allocs(allocs) == _allocs(jray.spread(JNODES, 6))


@pytest.mark.parametrize("n", [1, 5, 9, 10])
def test_torch_spread_and_pack_match_jax(n):
    assert _allocs(spread(NODES, n)) == _allocs(jray.spread(JNODES, n))
    assert _allocs(pack(NODES, n)) == _allocs(jray.pack(JNODES, n))
    assert _allocs(pack(NODES, n, False)) == _allocs(
        jray.pack(JNODES, n, False))


def test_torch_placement_capacity_errors():
    with pytest.raises(ValueError):
        pack(NODES, 11)
    with pytest.raises(ValueError):
        spread(NODES, 11)
    assert len(pack(NODES, 10)) == 10


@pytest.mark.parametrize("placement", ["pack", "spread"])
def test_torch_ray_executor_env_is_the_launchers(placement):
    ex = RayExecutor(num_workers=6, placement=placement,
                     env_vars={"X": 1})
    jex = jray.RayExecutor(num_workers=6, placement=placement)
    allocs = ex.compute_placement(NODES)
    jex.compute_placement(JNODES)
    hosts = []
    for a in allocs:
        if a.hostname not in [h for h, _ in hosts]:
            hosts.append((a.hostname, sum(1 for b in allocs
                                          if b.hostname == a.hostname)))
    coord = ("a", 1111, 2222)
    for a in allocs:
        env = ex.worker_env(a, coord)
        want = dict(_launcher_env(a.rank, hosts, 6, coord), X="1")
        assert env == want
        jenv = jex.worker_env(jex._allocations[a.rank], coord)
        assert {k: env[k] for k in jenv} == jenv
    env = ex.worker_env(allocs[4], coord)
    assert env["HOROVOD_RANK"] == "4" and env["HOROVOD_SIZE"] == "6"
    assert env["CUDA_MODULE_LOADING"] == "EAGER"
    if placement == "pack":
        assert env["HOROVOD_LOCAL_COUNTS"] == "4,2"
        assert env["HOROVOD_LOCAL_RANK"] == "0"
        assert env["HOROVOD_CROSS_RANK"] == "1"
        assert env["HOROVOD_HOSTNAME"] == "b"


def test_torch_ray_executor_requires_ray_to_start():
    ex = RayExecutor(num_workers=2)
    with pytest.raises(ImportError, match="ray"):
        ex.start()
    for call in (lambda: ex.run(len), lambda: ex.execute(len)):
        with pytest.raises(ImportError, match="horovod_tpu_torch.ray"):
            call()
    ex.shutdown()  # no-op without workers
    with pytest.raises(ValueError, match="placement"):
        RayExecutor(placement="scatter")


def test_torch_spark_run_requires_pyspark():
    import horovod_tpu_torch.spark as hvd_spark
    with pytest.raises(ImportError, match="pyspark"):
        hvd_spark.run(lambda: None, num_proc=2)
    assert not hasattr(hvd_spark, "JaxEstimator")


def test_torch_local_store(tmp_path):
    store = Store.create(str(tmp_path / "store"))
    jstore = jspark.Store.create(str(tmp_path / "jstore"))
    assert isinstance(store, LocalStore)
    ckpt = store.get_checkpoint_path("run1")
    assert os.path.relpath(ckpt, str(tmp_path / "store")) == os.path.relpath(
        jstore.get_checkpoint_path("run1"), str(tmp_path / "jstore"))
    store.write(os.path.join(ckpt, "model.bin"), b"\x00\x01")
    assert store.exists(os.path.join(ckpt, "model.bin"))
    assert store.read(os.path.join(ckpt, "model.bin")) == b"\x00\x01"
    assert store.get_train_data_path(3).endswith("intermediate_train_data.3")
    assert store.get_logs_path("run1") != ckpt
    store.delete(ckpt)
    assert not store.exists(ckpt)


def test_torch_store_unknown_scheme():
    with pytest.raises(NotImplementedError):
        Store.create("abfs://container/path")


class DictFS:
    """Injectable filesystem double for RemoteStore."""

    def __init__(self):
        self.blobs = {}

    def exists(self, path):
        return path in self.blobs or any(
            k.startswith(path.rstrip("/") + "/") for k in self.blobs)

    def read(self, path):
        return self.blobs[path]

    def write(self, path, data):
        self.blobs[path] = data

    def delete(self, path):
        for k in [k for k in self.blobs
                  if k == path or k.startswith(path.rstrip("/") + "/")]:
            del self.blobs[k]


@pytest.mark.parametrize("cls_name,prefix", [
    ("HDFSStore", "hdfs://namenode:9000/horovod"),
    ("S3Store", "s3://bucket/horovod"),
    ("GCSStore", "gs://bucket/horovod"),
])
def test_torch_remote_store_layout_and_io(cls_name, prefix):
    import horovod_tpu_torch.spark as hs
    fs, jfs = DictFS(), DictFS()
    store = getattr(hs, cls_name)(prefix, fs=fs)
    jstore = getattr(jspark, cls_name)(prefix, fs=jfs)
    for s in (store, jstore):
        assert s.get_train_data_path(3, run_id="r1") == \
            f"{prefix}/r1/intermediate_train_data.3"
        assert s.get_val_data_path(run_id="r1") == \
            f"{prefix}/r1/intermediate_val_data"
        ckpt = s.get_checkpoint_path("r1")
        assert ckpt == f"{prefix}/r1/checkpoint"
        assert s.get_logs_path("r1") != ckpt
        s.write(ckpt + "/model.bin", b"\x01\x02")
        assert s.exists(ckpt + "/model.bin") and s.exists(ckpt)
        assert s.read(ckpt + "/model.bin") == b"\x01\x02"
    assert fs.blobs == jfs.blobs
    store.delete(store.get_checkpoint_path("r1"))
    assert not store.exists(store.get_checkpoint_path("r1"))


def test_torch_remote_store_requires_client_library():
    from horovod_tpu_torch.spark import HDFSStore, S3Store
    with pytest.raises(ImportError, match="pyarrow"):
        HDFSStore("hdfs://nn/horovod")
    with pytest.raises(ImportError, match="boto3"):
        S3Store("s3://bucket/horovod")
    with pytest.raises(ImportError):
        Store.create("s3://bucket/horovod")
    with pytest.raises(ImportError):
        Store.create("hdfs://nn/horovod")


def test_torch_spark_task_env_is_the_launchers():
    """Every task computes a consistent world from the same gang view:
    the launcher's env for its rank, the JAX task env's HOROVOD_* values,
    and the host-major counts only where the gang lists hosts together."""
    from horovod_tpu_torch.spark import _task_env
    addresses = ["nodeA:1001", "nodeA:1002", "nodeB:1003"]
    envs = [_task_env(i, addresses, port_seed=42, extra_env={"X": 1})
            for i in range(3)]
    jenvs = [jspark._task_env(i, addresses, port_seed=42, extra_env={"X": 1})
             for i in range(3)]
    assert [e["HOROVOD_RANK"] for e in envs] == ["0", "1", "2"]
    assert all(e["HOROVOD_SIZE"] == "3" for e in envs)
    assert [e["HOROVOD_LOCAL_RANK"] for e in envs] == ["0", "1", "0"]
    assert [e["HOROVOD_LOCAL_SIZE"] for e in envs] == ["2", "2", "1"]
    assert [e["HOROVOD_CROSS_RANK"] for e in envs] == ["0", "0", "1"]
    assert all(e["HOROVOD_CONTROLLER_ADDR"] == "nodeA" for e in envs)
    ports = {(e["HOROVOD_CONTROLLER_PORT"], e["HOROVOD_CONTROLLER_PORT2"])
             for e in envs}
    assert len(ports) == 1
    assert all(e["X"] == "1" for e in envs)
    for r, (e, j) in enumerate(zip(envs, jenvs)):
        assert {k: e[k] for k in j} == j
        coord = (e["HOROVOD_CONTROLLER_ADDR"],
                 int(e["HOROVOD_CONTROLLER_PORT"]),
                 int(e["HOROVOD_CONTROLLER_PORT2"]))
        want = dict(_launcher_env(r, [("nodeA", 2), ("nodeB", 1)], 3,
                                  coord), X="1")
        assert e == want
    # Interleaved hosts: no host-major counts, so the world stays flat.
    mixed = ["nodeA:1", "nodeB:2", "nodeA:3"]
    envs = [_task_env(i, mixed, 7, {}) for i in range(3)]
    assert all("HOROVOD_LOCAL_COUNTS" not in e for e in envs)
    assert [e["HOROVOD_LOCAL_RANK"] for e in envs] == ["0", "0", "1"]


def test_torch_remote_ports_deterministic():
    from horovod_tpu.common.net import remote_ports as jports
    from horovod_tpu_torch.common.net import remote_ports
    assert remote_ports(2, 7) == remote_ports(2, 7) == jports(2, 7)
    assert remote_ports(2, 7) != remote_ports(2, 8)
    p = remote_ports(3, 123)
    assert p == jports(3, 123)
    assert all(20000 <= x < 60000 for x in p)


# ---------------------------------------------------------------- estimator
class FakeRow(dict):
    pass


class FakeDataFrame:
    """Test double with the DataFrame API surface the estimator touches."""

    def __init__(self, rows):
        self._rows = [FakeRow(r) for r in rows]

    def select(self, *cols):
        return FakeSelected([[r[c] for c in cols] for r in self._rows])

    def collect(self):
        return self._rows


class FakeSelected:
    def __init__(self, rows):
        self._rows = rows

    def collect(self):
        return self._rows


def _linear_rows(n=64, noise=0.01, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5], np.float32)
    y = X @ w + noise * rng.randn(n).astype(np.float32)
    return [{"f0": float(a), "f1": float(b), "f2": float(c), "label": float(t)}
            for (a, b, c), t in zip(X, y)]


def _linear_df(n=64, noise=0.01, seed=0):
    return FakeDataFrame(_linear_rows(n, noise, seed))


class _CollectOnly:
    def __init__(self, rows):
        self._rows = rows

    def collect(self):
        return self._rows


def test_torch_estimator_materialization_matches_jax(tmp_path):
    rows = _linear_rows(n=13, seed=4)
    cols = (["f0", "f1", "f2"], ["label"])
    for df in (FakeDataFrame(rows), _CollectOnly(rows), rows, []):
        got, want = test_._rows_to_arrays(df, *cols), \
            jest._rows_to_arrays(df, *cols)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    X, y = test_._rows_to_arrays(rows, *cols)
    store, jstore = LocalStore(str(tmp_path / "t")), \
        jspark.LocalStore(str(tmp_path / "j"))
    for shards in (1, 3, 5):
        assert test_._write_shards(store, X, y, shards, "r") == \
            jest._write_shards(jstore, X, y, shards, "r") == shards
        lens = set()
        for i in range(shards):
            got = test_._read_shard(store, i, "r")
            want = jest._read_shard(jstore, i, "r")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            lens.add(len(got[0]))
        assert len(lens) == 1       # equal-length shards
    assert test_._local_backend(lambda: 7, 1) == [7]
    with pytest.raises(RuntimeError, match="num_proc > 1"):
        test_._local_backend(lambda: 7, 2)


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    return thvd


def _torch_factory():
    import torch
    return torch.nn.Linear(3, 1)


def _torch_loss(p, t):
    import torch
    return torch.nn.functional.mse_loss(p, t.reshape(p.shape))


def test_torch_torch_estimator_fit_transform(port_cpu, hvd, tmp_path):
    import torch
    from horovod_tpu_torch.spark import TorchEstimator, TorchModel
    kw = dict(feature_cols=["f0", "f1", "f2"], label_cols=["label"],
              epochs=30, batch_size=16, learning_rate=0.1, run_id="torchrun")
    store = LocalStore(str(tmp_path / "t"))
    est = TorchEstimator(model_factory=_torch_factory, loss=_torch_loss,
                         store=store, device="cpu", **kw)
    model = est.fit(_linear_df())
    assert isinstance(model, TorchModel)
    w = model.params["weight"].numpy().reshape(-1)
    np.testing.assert_allclose(w, [1.0, -2.0, 0.5], atol=0.15)
    assert store.exists(store.get_train_data_path(0, run_id="torchrun"))
    assert store.exists(store.get_checkpoint_path("torchrun"))
    jmodel = jspark.TorchEstimator(
        model_factory=_torch_factory, loss=_torch_loss,
        store=jspark.LocalStore(str(tmp_path / "j")), **kw).fit(_linear_df())
    for k in jmodel.params:
        np.testing.assert_allclose(model.params[k].numpy(),
                                   jmodel.params[k].numpy(), rtol=1e-5,
                                   atol=1e-6)
    out = model.transform(_linear_df(n=5))
    assert len(out) == 5 and all("prediction" in r for r in out)
    # transform's predictions are the trained module's forward.
    X, _ = test_._rows_to_arrays(_linear_df(n=5), ["f0", "f1", "f2"],
                                 ["label"])
    mod = _torch_factory()
    mod.load_state_dict(model.params)
    with torch.no_grad():
        want = mod(torch.from_numpy(X)).numpy().reshape(-1)
    assert [r["prediction"] for r in out] == [float(v) for v in want]


@pytest.mark.parametrize("initialized", [False, True])
def test_torch_torch_model_device(initialized, monkeypatch):
    """``TorchModel`` predicts on the CPU only where the caller says so;
    with no ``device`` and no runtime it takes the card, and raises as
    ``init()`` does on a host without one."""
    import torch
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.spark import TorchModel
    monkeypatch.setattr(basics, "is_initialized", lambda: initialized)
    if initialized:
        monkeypatch.setattr(basics, "device", lambda: torch.device("cpu"))
    torch.manual_seed(0)
    params = _torch_factory().state_dict()
    X = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    mod = _torch_factory()
    mod.load_state_dict(params)
    with torch.no_grad():
        want = mod(torch.from_numpy(X)).numpy()
    got = TorchModel(params, _torch_factory, ["f0", "f1", "f2"],
                     device="cpu").predict(X)
    np.testing.assert_array_equal(got, want)
    model = TorchModel(params, _torch_factory, ["f0", "f1", "f2"])
    if initialized:     # hvd.device() of the runtime
        np.testing.assert_array_equal(model.predict(X), want)
    elif not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.predict(X)
    else:
        assert model.predict(X).shape == want.shape


def test_torch_keras_estimator_fit_transform(port_cpu, hvd, tmp_path):
    keras = pytest.importorskip("keras")
    from horovod_tpu_torch.spark import KerasEstimator, KerasModel

    def model_factory():
        return keras.Sequential([keras.layers.Input((3,)),
                                 keras.layers.Dense(1, use_bias=False)])

    kw = dict(model_factory=model_factory, loss="mse",
              feature_cols=["f0", "f1", "f2"], label_cols=["label"],
              epochs=30, batch_size=16, learning_rate=0.1, run_id="kerasrun")
    est = KerasEstimator(store=LocalStore(str(tmp_path / "t")),
                         device="cpu", **kw)
    model = est.fit(_linear_df())
    assert isinstance(model, KerasModel)
    w = np.asarray(model.params[0]).reshape(-1)
    np.testing.assert_allclose(w, [1.0, -2.0, 0.5], atol=0.15)
    jmodel = jspark.KerasEstimator(
        store=jspark.LocalStore(str(tmp_path / "j")), **kw).fit(_linear_df())
    np.testing.assert_allclose(w, np.asarray(jmodel.params[0]).reshape(-1),
                               rtol=1e-5, atol=1e-6)
    out = model.transform(_linear_df(n=5))
    assert len(out) == 5 and all("prediction" in r for r in out)
    preds = model.predict(np.array([[1.0, 0.0, 0.0]], np.float32))
    assert abs(float(preds.reshape(-1)[0]) - 1.0) < 0.2


def test_torch_estimator_empty_df_raises(port_cpu, tmp_path):
    from horovod_tpu_torch.spark import TorchEstimator
    est = TorchEstimator(model_factory=_torch_factory, loss=_torch_loss,
                         feature_cols=["f0"], label_cols=["label"],
                         store=LocalStore(str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        est.fit(FakeDataFrame([]))
    est = TorchEstimator(model_factory=_torch_factory, loss=_torch_loss,
                         feature_cols=["f0", "f1", "f2"],
                         label_cols=["label"], num_proc=2,
                         store=LocalStore(str(tmp_path)), device="cpu")
    with pytest.raises(RuntimeError, match="num_proc > 1"):
        est.fit(_linear_df(n=4))
    # The default store lies under the temporary directory.
    import tempfile
    default = TorchEstimator(model_factory=_torch_factory, loss=_torch_loss,
                             feature_cols=["f0"], label_cols=["label"])
    assert default.store.prefix_path.startswith(tempfile.gettempdir())


# ------------------------------------------------------------- ray elastic
class FakeRef:
    """Stands in for a Ray ObjectRef: completes (ok or failed) on demand."""

    def __init__(self):
        self.done = False
        self.failed = False


class FakeActor:
    def __init__(self):
        self.killed = False


class FakeRay:
    """The slice of the Ray API the elastic executor touches (reference
    tests elastic_v2 against mock clusters the same way)."""

    def __init__(self, nodes):
        self._nodes = nodes
        self.actors = []        # (actor, ref, env) in spawn order

    def nodes(self):
        return [dict(n) for n in self._nodes]

    def wait(self, refs, timeout=0):
        (ref,) = refs
        return ([ref] if ref.done else []), ([] if ref.done else [ref])

    def get(self, ref):
        if ref.failed:
            raise RuntimeError("actor died")
        return "ok"

    def kill(self, actor):
        actor.killed = True


def _fake_make_actor(executor, fake_ray):
    from horovod_tpu_torch.ray.elastic import _ActorProc

    def make(hostname, env):
        actor, ref = FakeActor(), FakeRef()
        fake_ray.actors.append((actor, ref, dict(env), hostname))
        return _ActorProc(fake_ray, actor, ref)

    executor._make_actor = make


def test_torch_ray_host_discovery_nodes_to_hosts():
    from horovod_tpu.ray import RayHostDiscovery as JaxDiscovery
    from horovod_tpu_torch.elastic.discovery import HostDiscovery
    from horovod_tpu_torch.ray import RayHostDiscovery
    fake = FakeRay([
        {"Alive": True, "NodeManagerAddress": "10.0.0.1",
         "Resources": {"CPU": 8, "TPU": 4}},
        {"Alive": True, "NodeManagerAddress": "10.0.0.2",
         "Resources": {"CPU": 8}},
        {"Alive": False, "NodeManagerAddress": "10.0.0.3",
         "Resources": {"CPU": 8, "TPU": 4}},
    ])
    d = RayHostDiscovery(use_accelerators=True, cpus_per_worker=2,
                         ray_api=fake)
    hosts = d.find_available_hosts_and_slots()
    assert isinstance(d, HostDiscovery)
    assert [(h.hostname, h.slots) for h in hosts] == [
        ("10.0.0.1", 4), ("10.0.0.2", 4)]   # dead node excluded; cpu fallback
    fake._nodes.append({"Alive": True, "NodeManagerAddress": "10.0.0.4",
                        "Resources": {"CPU": 16, "GPU": 8}})
    for accel in (True, False):
        got = RayHostDiscovery(accel, 2, ray_api=fake)
        want = JaxDiscovery(accel, 2, ray_api=fake)
        assert [(h.hostname, h.slots)
                for h in got.find_available_hosts_and_slots()] == [
            (h.hostname, h.slots)
            for h in want.find_available_hosts_and_slots()]


def test_torch_ray_elastic_actor_death_resumes_reduced_world():
    """VERDICT missing #7 'done' criterion (mock cluster): kill an actor
    mid-run -> its node is blacklisted, the world re-forms at reduced size,
    and training completes."""
    import threading
    import time
    from horovod_tpu_torch.ray import ElasticRayExecutor, RayHostDiscovery

    fake = FakeRay([
        {"Alive": True, "NodeManagerAddress": "nodeA",
         "Resources": {"CPU": 1}},
        {"Alive": True, "NodeManagerAddress": "nodeB",
         "Resources": {"CPU": 1}},
    ])
    ex = ElasticRayExecutor(min_workers=1, use_accelerators=False,
                            discovery_interval_s=0.05,
                            start_timeout_s=20, _ray_api=fake)
    _fake_make_actor(ex, fake)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault(
        "rc", ex.run(lambda: "trained")), daemon=True)
    t.start()

    # Wait for the first generation's 2 actors.
    deadline = time.monotonic() + 10
    while len(fake.actors) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(fake.actors) == 2, fake.actors
    first_hosts = {a[3] for a in fake.actors}
    assert first_hosts == {"nodeA", "nodeB"}
    # An actor's env: HOROVOD_* and the card's variables of the port's
    # elastic worker, not the driver's whole environment.
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.run import HostSpec, platform_worker_env
    assert isinstance(ex.driver, ElasticDriver)
    for _, _, env, host in fake.actors:
        card = platform_worker_env([HostSpec(host, 1)], 0, {},
                                   elastic=True)
        assert {k: env[k] for k in card} == card
        assert env["HOROVOD_ELASTIC"] == "1"
        assert env["HOROVOD_HOSTNAME"] == host
        assert all(k.startswith("HOROVOD_") or k in card for k in env)

    # Kill nodeB's actor: ref fails -> blacklist -> reduced regeneration.
    victim = next(a for a in fake.actors if a[3] == "nodeB")
    victim[1].failed = True
    victim[1].done = True

    deadline = time.monotonic() + 10
    while len(fake.actors) < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    # The regenerated world must exclude the blacklisted node.
    new = fake.actors[2:]
    assert new and all(a[3] == "nodeA" for a in new), fake.actors
    assert all(a[2]["HOROVOD_SIZE"] == "1" for a in new), \
        [a[2] for a in new]

    # Surviving actor finishes -> run() returns success.
    for a in new:
        a[1].done = True
    surviving = fake.actors[0]
    surviving[1].done = True
    t.join(timeout=15)
    assert rc.get("rc") == 0, rc


def test_torch_ray_elastic_coordinator_host_death_moves_world():
    """Variant killing the *coordinator-adjacent* actor (host 0 carries the
    controller): the world must re-form on the surviving host with the
    controller address moved off the blacklisted node."""
    import threading
    import time
    from horovod_tpu_torch.ray import ElasticRayExecutor

    fake = FakeRay([
        {"Alive": True, "NodeManagerAddress": "nodeA",
         "Resources": {"CPU": 1}},
        {"Alive": True, "NodeManagerAddress": "nodeB",
         "Resources": {"CPU": 1}},
    ])
    ex = ElasticRayExecutor(min_workers=1, use_accelerators=False,
                            discovery_interval_s=0.05,
                            start_timeout_s=20, _ray_api=fake)
    _fake_make_actor(ex, fake)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault(
        "rc", ex.run(lambda: "trained")), daemon=True)
    t.start()

    deadline = time.monotonic() + 10
    while len(fake.actors) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(fake.actors) == 2, fake.actors

    # Kill host 0's actor (rank 0 / controller host).
    victim = next(a for a in fake.actors if a[3] == "nodeA")
    victim[1].failed = True
    victim[1].done = True

    deadline = time.monotonic() + 10
    while len(fake.actors) < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    new = fake.actors[2:]
    assert new and all(a[3] == "nodeB" for a in new), fake.actors
    assert all(a[2]["HOROVOD_SIZE"] == "1" for a in new)
    assert all(a[2]["HOROVOD_RANK"] == "0" for a in new)
    # The controller no longer lives on the blacklisted host.
    assert all(a[2]["HOROVOD_CONTROLLER_ADDR"] == "nodeB" for a in new)

    for a in new:
        a[1].done = True
    t.join(timeout=15)
    assert rc.get("rc") == 0, rc


def test_torch_ray_elastic_requires_ray_without_fake():
    from horovod_tpu_torch.ray import ElasticRayExecutor
    ex = ElasticRayExecutor(min_workers=1)
    with pytest.raises(ImportError, match="ray"):
        ex.start()
