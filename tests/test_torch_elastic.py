"""The port's copied elastic modules against the JAX package's, by wire and
by value, and the launcher's elastic surface.

- ``compute_assignments`` of the port's driver and the JAX driver give the
  same assignments (but the freshly probed controller ports) over host
  lists that grow, shrink, hit the ``max_np`` cap, fall under ``min_np``
  and lose a blacklisted host.
- A port rendezvous client publishes to and fetches from a JAX
  ``RendezvousServer``, and the other way round (assignments, state
  records, notification ports).
- ``shard_bounds``, ``shard_of``, ``shard_slice_array``, ``encode_state``
  and ``blob_digest`` give the JAX bytes for numpy state dicts (exactly:
  the same blob, the same digest); the port's blob of a numpy dict decodes
  in the JAX package.
- A port ``StatePlane`` restores from a JAX ``ShardServer`` and the other
  way round (numpy state, bitwise, no disk read).
- The state plane's fault scenarios of the JAX package's
  ``tests/test_stateplane.py`` (a torn epoch, a transient and a persistent
  ``ckpt_write_fail``, a corrupt shard, ``restore_peer_exit`` on one of
  two donors and on the only one, a superseded write) give the same
  outcome in both packages, each armed through its own fault harness.
- The runner: the lifted flags forward their env, the remaining elastic
  flags still refuse, ``--host-discovery-script`` routes to the elastic
  driver, and the elastic worker env carries ProcessGroupNCCL's
  error-handling mode and the host-keyed ``NCCL_HOSTID``.
- The config's elastic fields have the JAX defaults.

The tests on the card are in ``tests/test_torch_elastic_cuda.py`` (which
imports no JAX).

Every comparison here is exact (bytes, digests, assignments, values).
"""

import os
import socket

import numpy as np
import pytest
import torch

from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.elastic import rendezvous as jrdv
from horovod_tpu.elastic import stateplane as jspl
from horovod_tpu.elastic.discovery import DiscoveredHost as JHost
from horovod_tpu.elastic.discovery import FixedHostDiscovery as JFixed
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.common.config import Config as PConfig
from horovod_tpu_torch.elastic import driver as pdriver
from horovod_tpu_torch.elastic import rendezvous as prdv
from horovod_tpu_torch.elastic import stateplane as pspl
from horovod_tpu_torch.elastic.discovery import DiscoveredHost as PHost
from horovod_tpu_torch.elastic.discovery import FixedHostDiscovery as PFixed
from horovod_tpu_torch.runner import run as prun
from horovod_tpu_torch.testing import faults as pfaults

PKGS = {"jax": (jspl, jfaults), "torch": (pspl, pfaults)}


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.disarm()
    pfaults.disarm()
    yield
    jfaults.disarm()
    pfaults.disarm()


# ----------------------------------------------------------- assignments
_PORTS = ("controller_port", "controller_port2")
SCENARIOS = {
    "grow": ([("h0", 1)], [("h0", 1), ("h1", 2)], 1, None),
    "shrink": ([("h0", 2), ("h1", 2)], [("h0", 2)], 1, None),
    "cap": ([("h0", 2), ("h1", 2), ("h2", 2)], [("h0", 4), ("h1", 1)], 1, 3),
    "under_min": ([("h0", 2), ("h1", 1)], [("h1", 1)], 2, None),
    "localhost_first": ([("localhost", 2), ("127.0.0.2", 1)],
                        [("127.0.0.2", 1), ("localhost", 1)], 1, 2),
}


def _assign(mod, host_cls, fixed_cls, hosts, min_np, max_np, blacklist=()):
    d = mod.ElasticDriver(fixed_cls([]), ["true"], min_np=min_np,
                          max_np=max_np)
    try:
        for h in blacklist:
            d.registry.record_failure(f"{h}:0")
        active = d.active_hosts([host_cls(n, s) for n, s in hosts])
        out = d.compute_assignments(active)
    finally:
        d.rendezvous.stop()
    for a in out.values():
        assert all(isinstance(a[k], int) and a[k] > 0 for k in _PORTS)
        for k in _PORTS:
            a.pop(k)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_torch_compute_assignments_match_jax(name):
    """Both generations of each scenario: the port's driver assigns as the
    JAX driver does (ranks host-major, local ranks and sizes, cross
    ranks, the coordinator's host; nothing under min_np)."""
    first, second, min_np, max_np = SCENARIOS[name]
    for hosts in (first, second):
        j = _assign(jdriver, JHost, JFixed, hosts, min_np, max_np)
        p = _assign(pdriver, PHost, PFixed, hosts, min_np, max_np)
        assert p == j
    assert bool(p) == (name != "under_min")


def test_torch_compute_assignments_skip_blacklisted_hosts():
    hosts = [("h0", 1), ("h1", 1), ("h2", 2)]
    j = _assign(jdriver, JHost, JFixed, hosts, 1, None, blacklist=("h1",))
    p = _assign(pdriver, PHost, PFixed, hosts, 1, None, blacklist=("h1",))
    assert p == j and sorted(p) == ["h0:0", "h2:0", "h2:1"]


# ------------------------------------------------------------ rendezvous
@pytest.mark.parametrize("server_pkg,client_pkg", [(jrdv, prdv), (prdv, jrdv)],
                         ids=["jax_server", "torch_server"])
def test_torch_rendezvous_wire_matches_jax(server_pkg, client_pkg):
    """One package's server, the other's client: versioned assignments,
    long-poll for a newer version, state records and notification ports
    cross the wire unchanged."""
    srv = server_pkg.RendezvousServer(addr="127.0.0.1")
    try:
        v1 = srv.publish({"h:0": {"rank": 0, "size": 1}})
        a = client_pkg.fetch_assignment("127.0.0.1", srv.port, "h:0",
                                        min_version=v1, timeout_s=5)
        assert a == {"rank": 0, "size": 1, "version": v1}
        with pytest.raises(TimeoutError):
            client_pkg.fetch_assignment("127.0.0.1", srv.port, "h:0",
                                        min_version=v1 + 1, timeout_s=0.5)
        rec = {"epoch": 3, "port": 1234, "digest": "ab", "total": 9}
        client_pkg.declare_state("127.0.0.1", srv.port, "h:0", rec)
        assert client_pkg.state_directory("127.0.0.1", srv.port) == \
            {"h:0": rec} == srv.state_records()
        client_pkg.register_notification_port("127.0.0.1", srv.port, "h:0",
                                              4321)
        assert srv.notification_ports() == {"h:0": 4321}
        srv.drop_state("h:0")
        assert client_pkg.state_directory("127.0.0.1", srv.port) == {}
    finally:
        srv.stop()


# ------------------------------------------------------- shard math, blobs
def _numpy_state(seed, n=1000):
    rs = np.random.RandomState(seed)
    return {"params": rs.randn(n).astype(np.float32),
            "moments": {"m": rs.randn(7, 3), "v": rs.randint(0, 9, (5,))},
            "step": seed, "note": f"s{seed}",
            "ints": np.arange(n % 97, dtype=np.int64)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_torch_encode_and_digest_give_the_jax_bytes(seed):
    st = _numpy_state(seed, 500 + 211 * seed)
    jb, pb = jspl.encode_state(st), pspl.encode_state(st)
    assert pb == jb
    assert pspl.blob_digest(pb) == jspl.blob_digest(jb)
    out = jspl.decode_state(pb)
    np.testing.assert_array_equal(out["params"], st["params"])
    assert out["step"] == seed
    back = pspl.decode_state(jb)
    assert pspl.encode_state(back) == jb


@pytest.mark.parametrize("world", [1, 2, 3, 8, 16])
def test_torch_shard_math_matches_jax(world):
    blob = bytes(range(256)) * 7 + b"tail"
    assert pspl.shard_bounds(len(blob), world) == \
        jspl.shard_bounds(len(blob), world)
    for i in range(world):
        assert pspl.shard_of(blob, i, world) == jspl.shard_of(blob, i, world)
    arr = np.arange(37, dtype=np.float32)
    for r in range(world):
        np.testing.assert_array_equal(pspl.shard_slice_array(arr, r, world),
                                      jspl.shard_slice_array(arr, r, world))


@pytest.mark.parametrize("donor_pkg,joiner_pkg", [("jax", "torch"),
                                                  ("torch", "jax")])
def test_torch_peer_restore_across_packages(tmp_path, donor_pkg,
                                            joiner_pkg):
    """Two donors of one package serve a joiner of the other: a peer
    restore, bitwise, with zero disk reads and the donors' digest."""
    dspl, jspl_ = PKGS[donor_pkg][0], PKGS[joiner_pkg][0]
    st = _numpy_state(7, 4099)
    donors = [dspl.StatePlane(str(tmp_path / f"d{r}"), rank=r, world=2,
                              serve=True) for r in range(2)]
    for p in donors:
        p.commit(state=st, epoch=5)
    try:
        j = jspl_.StatePlane(str(tmp_path / "j"), serve=False)
        data, epoch, source = j.restore(
            peers=[("127.0.0.1", p.server.port) for p in donors])
        assert (epoch, source, j.disk_reads) == (5, "peer", 0)
        assert j.peer_shards_fetched == 2
        np.testing.assert_array_equal(data["params"], st["params"])
        assert j.memory_state()[2] == donors[0].memory_state()[2] == \
            jspl.blob_digest(jspl.encode_state(st))
    finally:
        for p in donors:
            p.close()


def test_torch_disk_restore_across_packages(tmp_path):
    """Epochs written by the port's planes restore from disk in the JAX
    package (and back): the manifests and shard files are the same."""
    st = _numpy_state(3, 3001)
    planes = [pspl.StatePlane(str(tmp_path), rank=r, world=2, serve=False)
              for r in range(2)]
    for p in planes:
        assert p.wait_durable(p.commit(state=st, epoch=4), 10)
    data, epoch, source = jspl.StatePlane(str(tmp_path),
                                          serve=False).restore()
    assert (epoch, source) == (4, "disk")
    np.testing.assert_array_equal(data["params"], st["params"])
    assert pspl.epoch_manifests(str(tmp_path), 4) == \
        jspl.epoch_manifests(str(tmp_path), 4)


# ------------------------------------------------------- fault scenarios
def _st(e, n=2048):
    return {"step": e, "note": f"e{e}",
            "params": np.arange(n, dtype=np.float32) * float(e)}


def _plane(spl, d, rank=0, world=1, serve=False):
    return spl.StatePlane(str(d), rank=rank, world=world, serve=serve,
                          io_backoff_ms=1.0)


def _torn(spl, faults, d):
    p = _plane(spl, d)
    assert p.wait_durable(p.commit(state=_st(1)), 10)
    faults.arm("ckpt_torn:0:io_error")
    p._fire = faults.fire
    e1 = p.commit(state=_st(2))
    durable = p.wait_durable(e1, 10)
    faults.disarm()
    torn = os.path.join(d, f"epoch_{e1:010d}")
    data, epoch, source = _plane(spl, d).restore()
    return (durable, p.write_failures,
            os.path.exists(os.path.join(torn, "shard_0_of_1.bin")),
            os.path.exists(os.path.join(torn, "shard_0_of_1.json")),
            epoch, source, float(data["params"][1]))


def _transient(spl, faults, d):
    faults.arm("ckpt_write_fail:0:io_error")
    p = _plane(spl, d)
    e = p.commit(state=_st(1))
    return (p.wait_durable(e, 10), faults.fired(), p.write_failures,
            spl.latest_complete_epoch(str(d)) == e)


def _persistent(spl, faults, d):
    p = _plane(spl, d)
    e0 = p.commit(state=_st(1), wait=True)
    faults.arm("ckpt_write_fail:0:io_error:0")
    p._fire = faults.fire
    e1 = p.commit(state=_st(2))
    durable = p.wait_durable(e1, 10)
    faults.disarm()
    data, epoch, source = _plane(spl, d).restore()
    ed = os.path.join(d, f"epoch_{e1:010d}")
    left = os.path.exists(ed) and any(
        f.endswith((".bin", ".json")) for f in os.listdir(ed))
    return (durable, p.write_failures, p.durable_epoch == e0, epoch, source,
            float(data["params"][1]), left)


def _corrupt(spl, faults, d):
    planes = [_plane(spl, d, rank=r, world=2) for r in range(2)]
    for e in (1, 2):
        for p in planes:
            assert p.wait_durable(p.commit(state=_st(e), epoch=e), 10)
    victim = os.path.join(d, "epoch_0000000002", "shard_1_of_2.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[7] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    j = _plane(spl, d)
    data, epoch, source = j.restore()
    return (epoch, source, float(data["params"][1]),
            [os.path.basename(q) for q in j.quarantined])


def _peer_death(spl, faults, d):
    donors = [_plane(spl, os.path.join(d, f"d{r}"), rank=r, world=2,
                     serve=True) for r in range(2)]
    for p in donors:
        p.commit(state=_st(5), epoch=5)
    faults.arm("restore_peer_exit:0:econnreset")
    donors[0]._fire = faults.fire
    try:
        j = _plane(spl, os.path.join(d, "j"), world=2)
        data, epoch, source = j.restore(
            peers=[("127.0.0.1", p.server.port) for p in donors])
        return (epoch, source, faults.fired(), j.disk_reads,
                float(data["params"][1]))
    finally:
        for p in donors:
            p.close()


def _sole_peer_death(spl, faults, d):
    donor = _plane(spl, d, serve=True)
    donor.commit(state=_st(2), epoch=2, wait=True)
    faults.arm("restore_peer_exit:0:econnreset")
    donor._fire = faults.fire
    try:
        j = _plane(spl, d)
        data, epoch, source = j.restore(
            peers=[("127.0.0.1", donor.server.port)])
        return (epoch, source, j.restore_fallbacks, float(data["params"][1]))
    finally:
        donor.close()


def _supersede(spl, faults, d):
    class Park:
        def __init__(self):
            self.items = []

        def submit_checkpoint_io(self, items):
            self.items.extend(items)

    eng = Park()
    p = _plane(spl, d)
    p.engine = eng
    e1 = p.commit(state=_st(1))
    e2 = p.commit(state=_st(2))
    for it in eng.items:
        it.run()
    d1 = os.path.join(d, f"epoch_{e1:010d}")
    return (p.durable_epoch == e2, spl.latest_complete_epoch(str(d)) == e2,
            os.path.exists(d1) and any(f.endswith((".bin", ".json"))
                                       for f in os.listdir(d1)))


FAULTS = {
    "torn": (_torn, (False, 1, True, False, 0, "disk", 1.0)),
    "transient_write_fail": (_transient, (True, True, 0, True)),
    "persistent_write_fail": (_persistent,
                              (False, 1, True, 0, "disk", 1.0, False)),
    "corrupt_shard": (_corrupt, (1, "disk", 1.0,
                                 ["shard_1_of_2.bin.quarantined"])),
    "restore_peer_exit": (_peer_death, (5, "peer", True, 0, 5.0)),
    "restore_sole_peer_exit": (_sole_peer_death, (2, "disk", 1, 2.0)),
    "superseded_write": (_supersede, (True, True, False)),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_torch_stateplane_fault_scenarios_match_jax(tmp_path, name):
    """Each fault scenario in both packages: the outcome the JAX package's
    tests pin, and the same in the port."""
    fn, want = FAULTS[name]
    got = {}
    for pkg, (spl, faults) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = fn(spl, faults, str(d))
        faults.disarm()
    assert got["jax"] == want
    assert got["torch"] == got["jax"]


def test_torch_write_job_hashes_its_shard_chunk_by_chunk(tmp_path):
    """The port's write job takes the shard's digest a chunk at a time (a
    retried chunk once): the manifest holds the whole shard's digest."""
    pfaults.arm("ckpt_write_fail:1:io_error:2")     # the second chunk, once
    p = pspl.StatePlane(str(tmp_path), rank=1, world=3, serve=False,
                        chunk_bytes=1000, io_backoff_ms=1.0)
    st = _st(3, 5000)
    e = p.commit(state=st)
    assert p.wait_durable(e, 10) and pfaults.fired()
    blob = pspl.encode_state(st)
    man = pspl.epoch_manifests(str(tmp_path), e)
    assert man is None          # only rank 1 of 3 wrote
    rec = __import__("json").load(open(
        tmp_path / f"epoch_{e:010d}" / "shard_1_of_3.json"))
    assert rec["digest"] == jspl.blob_digest(jspl.shard_of(blob, 1, 3))
    assert rec["blob_digest"] == jspl.blob_digest(blob)


# ---------------------------------------------------------------- runner
LIFTED = {
    "--min-np": ("2", None), "--max-np": ("3", None),
    "--slots-per-host": ("2", None),
    "--host-discovery-script": ("cat hosts", None),
    "--ckpt-dir": ("/tmp/ck", ("HOROVOD_CKPT_DIR", "/tmp/ck")),
    "--ckpt-chunk-mb": ("16", ("HOROVOD_CKPT_CHUNK", str(16 << 20))),
    "--ckpt-lane-budget": ("3", ("HOROVOD_CKPT_LANE_BUDGET", "3")),
}


@pytest.mark.parametrize("flag", sorted(LIFTED))
def test_torch_runner_lifted_elastic_flag(flag):
    """Each flag this slice lifts parses (no refusal) and forwards its env
    where it has one."""
    value, env = LIFTED[flag]
    assert flag not in prun.NOT_PORTED
    args = prun.parse_args(["-np", "2", flag, value, "python", "t.py"])
    assert getattr(args, prun._dest(flag)) is not None
    if env is not None:
        assert prun.tuning_env(args)[env[0]] == env[1]


def test_torch_runner_remaining_elastic_flags_refuse():
    left = {f for f, why in prun.NOT_PORTED.items() if "item 6b" in why}
    assert left == {"--autoscale", "--autoscale-interval", "--scale-command",
                    "--preempt-grace-s", "--commit-max-age-s",
                    "--hierarchical-controller"}
    assert prun.NOT_PORTED["--tpu-metadata-discovery"] == prun._TPU


def test_torch_runner_routes_discovery_to_the_elastic_driver(monkeypatch):
    seen = {}
    monkeypatch.setattr(pdriver, "run_elastic",
                        lambda args: seen.setdefault("args", args) and 7)
    rc = prun.main(["--host-discovery-script", "cat h", "--min-np", "1",
                    "--max-np", "2", "--ckpt-dir", "/tmp/x", "python",
                    "t.py"])
    assert rc == 7 and seen["args"].max_np == 2
    assert seen["args"].command == ["python", "t.py"]


def test_torch_elastic_worker_env(monkeypatch):
    """The driver's worker env: HOROVOD_ELASTIC and the rendezvous, eager
    module loading, ProcessGroupNCCL's abort-and-keep mode (2), and an
    NCCL_HOSTID keyed on the host entry's name (loopback: NCCL's sockets
    on lo) whatever the other hosts; a remote host gets no host id."""
    for k in ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "NCCL_HOSTID",
              "NCCL_SOCKET_IFNAME", "NCCL_IB_DISABLE", "CUDA_MODULE_LOADING"):
        monkeypatch.delenv(k, raising=False)
    d = pdriver.ElasticDriver(PFixed([]), ["true"], min_np=1)
    try:
        env = d._worker_env("127.0.0.2:0", "127.0.0.2", 0)
        assert env["HOROVOD_ELASTIC"] == "1"
        assert env["HOROVOD_RENDEZVOUS_PORT"] == str(d.rendezvous.port)
        assert env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "2"
        assert env["NCCL_HOSTID"] == "hvd-127.0.0.2"
        assert (env["NCCL_SOCKET_IFNAME"], env["NCCL_IB_DISABLE"]) == \
            ("lo", "1")
        assert env["CUDA_MODULE_LOADING"] == "EAGER"
        assert d._worker_env("127.0.0.3:0", "127.0.0.3", 0)["NCCL_HOSTID"] \
            == "hvd-127.0.0.3"
        remote = d._worker_env("gpu-node-7:0", "gpu-node-7", 0)
        assert "NCCL_HOSTID" not in remote
        assert remote["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "2"
        monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        assert d._worker_env("127.0.0.2:0", "127.0.0.2", 0)[
            "TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "1"     # the user's choice
    finally:
        d.rendezvous.stop()
    # The static launcher keeps its cross-rank key.
    hosts = [prun.HostSpec("localhost", 1), prun.HostSpec("127.0.0.1", 1)]
    assert prun.platform_worker_env(hosts, 1, {})["NCCL_HOSTID"] == \
        "hvd-1-127.0.0.1"
    assert "TORCH_NCCL_ASYNC_ERROR_HANDLING" not in \
        prun.platform_worker_env(hosts, 1, {})


def test_torch_elastic_config_defaults_match_jax(monkeypatch):
    for k in ("ELASTIC", "CKPT_DIR"):
        monkeypatch.delenv("HOROVOD_" + k, raising=False)
        monkeypatch.delenv("HVD_TPU_" + k, raising=False)
    j, p = JConfig.from_env(), PConfig.from_env()
    for f in ("elastic", "ckpt_dir", "ckpt_chunk_bytes", "ckpt_lane_budget"):
        assert getattr(p, f) == getattr(j, f), f
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv("HOROVOD_CKPT_DIR", "/tmp/d")
    j, p = JConfig.from_env(), PConfig.from_env()
    for f in ("elastic", "ckpt_dir"):
        assert getattr(p, f) == getattr(j, f), f


def test_torch_notification_service_pings(monkeypatch):
    """The copied notification service: HOSTS_UPDATED raises at the next
    check, COMMIT is acknowledged and consumed once, DRAIN raises
    DrainRequested."""
    from horovod_tpu_torch.common.exceptions import (DrainRequested,
                                                     HostsUpdatedInterrupt)
    from horovod_tpu_torch.elastic import worker
    monkeypatch.delenv("HOROVOD_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.setattr(worker, "_current_version", 1)
    m = worker.WorkerNotificationManager()

    def ping(msg):
        with socket.create_connection(("127.0.0.1", m._service.port),
                                      timeout=5) as s:
            s.sendall(msg)
            s.settimeout(5)
            return s.recv(8)

    try:
        ping(b"HOSTS_UPDATED 1\n")          # not news: already joined
        m.raise_if_updated()
        ping(b"HOSTS_UPDATED 2\n")
        with pytest.raises(HostsUpdatedInterrupt):
            m.raise_if_updated()
        assert ping(b"COMMIT\n") == b"ACK\n"
        assert m.consume_commit_request() and not m.consume_commit_request()
        ping(b"DRAIN\n")
        with pytest.raises(DrainRequested):
            m.raise_if_updated()
    finally:
        m._service.stop()


def test_torch_peer_fetch_waits_for_a_slow_donor(tmp_path, monkeypatch):
    """A donor that takes longer than the base timeout to digest its
    piece (a blob of gigabytes: 6-7 s over 4.2 GB on the card's host)
    still serves the joiner: the wait grows with the piece's bytes.  With
    the JAX package's fixed wait the fetch timed out and the restore fell
    back to disk."""
    monkeypatch.setattr(pspl, "FETCH_TIMEOUT_S", 0.3)
    monkeypatch.setattr(pspl, "FETCH_MIN_RATE", 2000.0)   # +1.5 s / 3 kB
    real = pspl.blob_digest

    def slow(b):
        if len(b) > 1000:
            import time
            time.sleep(0.8)
        return real(b)

    st = _numpy_state(2, 700)
    donors = [pspl.StatePlane(str(tmp_path / f"d{r}"), rank=r, world=2,
                              serve=True) for r in range(2)]
    for p in donors:
        p.commit(state=st, epoch=3)
    monkeypatch.setattr(pspl, "blob_digest", slow)
    try:
        j = pspl.StatePlane(str(tmp_path / "j"), serve=False)
        data, epoch, source = j.restore(
            peers=[("127.0.0.1", p.server.port) for p in donors])
        assert (epoch, source, j.disk_reads) == (3, "peer", 0)
        np.testing.assert_array_equal(data["params"], st["params"])
    finally:
        for p in donors:
            p.close()
