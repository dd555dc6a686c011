"""The port's launcher (``python -m horovod_tpu_torch.runner``) against the
cases of ``tests/test_runner.py`` that apply to it, each run on the JAX
launcher and on the port's, as cases of one test: host parsing, the
hostfile, arguments and the config file, placement, ``worker_envs``,
``ssh_command``, a local launch end to end, failure propagation and the
bootstrap services.  Then what only the port has: the card's env (no JAX
or XLA variable; ``NCCL_HOSTID`` where two ``-H`` entries are one machine)
and the refusal of every flag whose feature it lacks; the seven
observability flags forwarded as the JAX launcher forwards them; the
``--hierarchical-*`` switches forwarded on both launchers, the ranks per
host that every worker gets, and four ``-H`` entries of this machine
spawned here, not by ssh; the three sharded-optimizer flags forwarded as
the JAX launcher forwards them (the counterpart of
``test_sharded_flag_forwards_fleet_uniform_env``); ``--serve`` and
``--serve-port`` forwarded on the static and the elastic path.

No counterpart: ``test_platform_worker_env_cpu_hygiene`` (JAX's CPU
collectives and XLA device-count flag; the card's env replaces it),
and ``TestTPUVMBackend`` (``runner/tpu_vm.py`` has no GPU counterpart; its
flags are refused).
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import threading

import pytest

from horovod_tpu_torch.runner import run as port_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNERS = ["horovod_tpu.runner", "horovod_tpu_torch.runner"]


def _mod(pkg, name="run"):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=RUNNERS, ids=["jax", "port"])
def run(request):
    return _mod(request.param)


@pytest.fixture(params=RUNNERS, ids=["jax", "port"])
def bootstrap(request):
    return _mod(request.param, "bootstrap")


def test_torch_runner_parse_hosts(run):
    specs = run.parse_hosts("a:4,b:2,c")
    assert [(s.hostname, s.slots) for s in specs] == [("a", 4), ("b", 2),
                                                      ("c", 1)]


def test_torch_runner_parse_hostfile(run, tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# comment\nnode1 slots=4\nnode2 slots=2  # trailing\n\n"
                 "node3\n")
    specs = run.parse_hostfile(str(f))
    assert [(s.hostname, s.slots) for s in specs] == [
        ("node1", 4), ("node2", 2), ("node3", 1)]


def test_torch_runner_parse_args_basic(run):
    args = run.parse_args(["-np", "4", "python", "train.py", "--lr", "0.1"])
    assert args.np == 4
    assert args.command == ["python", "train.py", "--lr", "0.1"]


@pytest.mark.parametrize("argv", [["python", "train.py"], ["-np", "2"]],
                         ids=["requires-np", "requires-command"])
def test_torch_runner_parse_args_refuses(run, argv):
    with pytest.raises(SystemExit):
        run.parse_args(argv)


def test_torch_runner_config_file(run, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("fusion-threshold-mb: 32\ncycle-time-ms: 2.5\n"
                   "max-inflight: 3\n")
    args = run.parse_args(["-np", "2", "--config-file", str(cfg),
                           "python", "t.py"])
    assert args.fusion_threshold_mb == 32
    assert args.cycle_time_ms == 2.5
    assert args.max_inflight == 3


def test_torch_runner_placement_overflow(run):
    args = run.parse_args(["-np", "8", "-H", "a:2,b:2", "python", "t.py"])
    with pytest.raises(ValueError, match="only 4 slots"):
        run.placement(args)


def test_torch_runner_worker_envs(run):
    args = run.parse_args(["-np", "4", "-H", "a:2,b:2",
                           "--fusion-threshold-mb", "16",
                           "--round-timeout", "30", "python", "t.py"])
    hosts = run.placement(args)
    envs = run.worker_envs(args, hosts, ("1.2.3.4", 5555, 5556))
    assert len(envs) == 4
    assert envs[0]["HOROVOD_RANK"] == "0"
    assert envs[3]["HOROVOD_RANK"] == "3"
    assert envs[2]["HOROVOD_LOCAL_RANK"] == "0"
    assert envs[2]["HOROVOD_CROSS_RANK"] == "1"
    assert all(e["HOROVOD_SIZE"] == "4" for e in envs)
    assert all(e["HOROVOD_CONTROLLER_ADDR"] == "1.2.3.4" for e in envs)
    assert [(e["HOROVOD_CONTROLLER_PORT"], e["HOROVOD_CONTROLLER_PORT2"])
            for e in envs] == [("5555", "5556")] * 4
    assert envs[0]["HOROVOD_FUSION_THRESHOLD"] == str(16 * 1024 * 1024)
    assert envs[1]["HOROVOD_ROUND_TIMEOUT_S"] == "30.0"
    assert all("HOROVOD_AGENT_PORT" not in e for e in envs)


def test_torch_runner_ssh_command(run):
    env = {"HOROVOD_RANK": "3", "HOROVOD_SIZE": "4"}
    cmd = run.ssh_command("node2", env, ["python", "train.py"],
                          ssh_port=2222, identity_file="/id")
    assert cmd[0] == "ssh"
    assert "-p" in cmd and "2222" in cmd
    assert "-i" in cmd and "/id" in cmd
    assert cmd[-2] == "node2"
    remote = cmd[-1]
    assert "HOROVOD_RANK=3" in remote and "python train.py" in remote
    assert os.getcwd() in remote


def test_torch_runner_local_launch_end_to_end(run, tmp_path):
    """Spawn 2 local worker processes and check the injected env."""
    out = tmp_path / "o"
    script = tmp_path / "w.py"
    script.write_text(
        "import os\n"
        "print(os.environ['HOROVOD_RANK'], os.environ['HOROVOD_SIZE'])\n")
    args = run.parse_args(["-np", "2", "--output-filename", str(out),
                           sys.executable, str(script)])
    assert run.launch_workers(args, run.placement(args)) == 0
    assert (out / "rank.0" / "stdout").read_text().strip() == "0 2"
    assert (out / "rank.1" / "stdout").read_text().strip() == "1 2"


def test_torch_runner_local_launch_propagates_failure(run, tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(3)\n")
    args = run.parse_args(["-np", "2", sys.executable, str(script)])
    assert run.launch_workers(args, run.placement(args)) == 3


# ---------------------------------------------------------------- bootstrap
def _probe_thread(bootstrap, port, label, nic=None):
    rc = {}
    t = threading.Thread(
        target=lambda: rc.setdefault(
            "rc", bootstrap.probe_main("127.0.0.1", port, label, nic)),
        daemon=True)
    t.start()
    return t, rc


def test_torch_runner_list_nics_has_loopback(bootstrap):
    assert bootstrap.list_nics().get("lo") == "127.0.0.1"


def test_torch_runner_register_and_matrix_ok(bootstrap):
    svc = bootstrap.DriverService(["localhost"], timeout_s=20)
    t, rc = _probe_thread(bootstrap, svc.port, "localhost")
    try:
        addrs = svc.run()
    finally:
        svc.close()
    t.join(timeout=10)
    assert addrs == {"localhost": "127.0.0.1"} and rc.get("rc") == 0


def test_torch_runner_nic_selection_and_missing_nic(bootstrap):
    svc = bootstrap.DriverService(["localhost"], nic="lo", timeout_s=20)
    t, _ = _probe_thread(bootstrap, svc.port, "localhost", nic="lo")
    try:
        addrs = svc.run()
    finally:
        svc.close()
    t.join(timeout=10)
    assert addrs == {"localhost": "127.0.0.1"}
    svc = bootstrap.DriverService(["localhost"], nic="no_such_nic0",
                                  timeout_s=20)
    t, _ = _probe_thread(bootstrap, svc.port, "localhost",
                         nic="no_such_nic0")
    try:
        with pytest.raises(RuntimeError, match="no interface named"):
            svc.run()
    finally:
        svc.close()
    t.join(timeout=10)


def test_torch_runner_connectivity_failure_names_pair(bootstrap):
    """A fake peer registers with a dead listen port: the launch must
    refuse naming exactly (real host, fake host)."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    svc = bootstrap.DriverService(["localhost", "ghost"], timeout_s=30)
    t, _ = _probe_thread(bootstrap, svc.port, "localhost")

    def fake_ghost():
        s = socket.create_connection(("127.0.0.1", svc.port), timeout=10)
        s.sendall((json.dumps(
            {"type": "register", "host": "ghost", "nics": {},
             "addr": None, "listen_port": dead_port, "slots": 1,
             "nic_found": True}) + "\n").encode())
        fh = s.makefile()
        fh.readline()                      # check request
        s.sendall((json.dumps(
            {"type": "result", "host": "ghost",
             "reachable": {"localhost": True}}) + "\n").encode())
        fh.readline()
        s.close()

    g = threading.Thread(target=fake_ghost, daemon=True)
    g.start()
    try:
        with pytest.raises(RuntimeError,
                           match="'localhost' cannot reach .*'ghost'"):
            svc.run()
    finally:
        svc.close()
    t.join(timeout=15)
    g.join(timeout=15)


def test_torch_runner_timeout_names_missing_host(bootstrap):
    svc = bootstrap.DriverService(["localhost", "never-shows-up"],
                                  timeout_s=2)
    t, _ = _probe_thread(bootstrap, svc.port, "localhost")
    try:
        with pytest.raises(RuntimeError, match="never-shows-up"):
            svc.run()
    finally:
        svc.close()
    t.join(timeout=15)


def test_torch_runner_probe_runs_on_the_port_module():
    """The probe command the port's bootstrap spawns names the port's own
    module, and the module starts."""
    src = open(port_run.__file__.replace("run.py", "bootstrap.py")).read()
    assert "horovod_tpu.runner.task_probe" not in src
    assert src.count("horovod_tpu_torch.runner.task_probe") >= 2
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.task_probe",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--driver-addr" in res.stdout


# ------------------------------------------------------- the port's own
def test_torch_runner_card_env_hygiene():
    """No JAX or XLA variable reaches a worker, and no CUDA_VISIBLE_DEVICES:
    each worker takes cuda:{HOROVOD_LOCAL_RANK}."""
    args = port_run.parse_args(["-np", "4", "-H", "a:2,b:2", "python",
                                "t.py"])
    envs = port_run.worker_envs(args, port_run.placement(args),
                                ("1.2.3.4", 5555, 5556))
    for e in envs:
        assert not [k for k in e if k.startswith(("JAX_", "XLA_"))], e
        assert "CUDA_VISIBLE_DEVICES" not in e
        assert "NCCL_HOSTID" not in e        # two machines
    assert [e["HOROVOD_LOCAL_RANK"] for e in envs] == ["0", "1", "0", "1"]


def test_torch_runner_one_machine_twice_gets_a_host_id_an_entry():
    """``-H localhost:1,127.0.0.1:1`` names one machine twice (two ranks on
    one card): each entry gets its own NCCL_HOSTID and the socket
    transport on the loopback device; each rank is local rank 0."""
    args = port_run.parse_args(["-np", "2", "-H", "localhost:1,127.0.0.1:1",
                                "python", "t.py"])
    hosts = port_run.placement(args)
    envs = port_run.worker_envs(args, hosts, ("127.0.0.1", 5555, 5556))
    assert [e["HOROVOD_LOCAL_RANK"] for e in envs] == ["0", "0"]
    ids = [e["NCCL_HOSTID"] for e in envs]
    assert len(set(ids)) == 2
    assert all(e["NCCL_SOCKET_IFNAME"] == "lo" and e["NCCL_IB_DISABLE"] == "1"
               for e in envs)
    # The user's own choice stays.
    env = port_run.platform_worker_env(hosts, 1, {"NCCL_SOCKET_IFNAME": "eth0"})
    assert env["NCCL_SOCKET_IFNAME"] == "eth0"
    # One entry with two slots is one host to NCCL: nothing added.
    args = port_run.parse_args(["-np", "2", "-H", "localhost:2", "python",
                                "t.py"])
    envs = port_run.worker_envs(args, port_run.placement(args),
                                ("127.0.0.1", 5555, 5556))
    assert all("NCCL_HOSTID" not in e for e in envs)
    assert [e["HOROVOD_LOCAL_RANK"] for e in envs] == ["0", "1"]


def test_torch_runner_workers_load_kernels_eagerly():
    """Every worker gets ``CUDA_MODULE_LOADING=EAGER`` (a kernel loaded
    lazily beside a collective spinning for a peer can wait for ever),
    on one machine or two; the user's own value stays."""
    for hosts in ("a:2,b:2", "localhost:1,127.0.0.1:1"):
        args = port_run.parse_args(["-np", "2", "-H", hosts, "python",
                                    "t.py"])
        envs = port_run.worker_envs(args, port_run.placement(args),
                                    ("127.0.0.1", 5555, 5556))
        assert all(e["CUDA_MODULE_LOADING"] == "EAGER" for e in envs)
    env = port_run.platform_worker_env(port_run.placement(args), 0,
                                       {"CUDA_MODULE_LOADING": "LAZY"})
    assert env["CUDA_MODULE_LOADING"] == "LAZY"


@pytest.mark.parametrize("size,device,driver_up,user,want", [
    (2, None, False, None, "EAGER"),          # asked for before cuInit
    (2, "cuda:0", False, None, "EAGER"),
    (2, None, True, None, None),              # too late: init warns
    (2, None, False, "LAZY", "LAZY"),         # the user's choice stays
    (1, None, False, None, None),             # no collectives at size 1
    (2, "cpu", False, None, None),            # gloo on the CPU
])
def test_torch_init_asks_for_eager_module_loading(monkeypatch, size, device,
                                                  driver_up, user, want):
    """``hvd.init()`` asks for eager module loading where it will run
    collectives on a card, the user chose no mode and the driver does not
    yet read one."""
    from horovod_tpu_torch.common import basics
    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    if user is not None:
        monkeypatch.setenv("CUDA_MODULE_LOADING", user)
    monkeypatch.setattr(basics, "_cuda_driver_initialized",
                        lambda: driver_up)
    basics._ask_eager_module_loading(size, device)
    assert os.environ.get("CUDA_MODULE_LOADING") == want


@pytest.mark.parametrize("flag", sorted(port_run.NOT_PORTED))
def test_torch_runner_refuses_what_is_not_ported(flag, capsys, tmp_path):
    """Each flag whose feature the port lacks is refused when parsed,
    naming what brings it, on the command line and in a config file."""
    why = port_run.NOT_PORTED[flag]
    value = [] if flag in port_run._SWITCHES else ["1"]
    with pytest.raises(SystemExit):
        port_run.parse_args(["-np", "2", flag, *value, "python", "t.py"])
    err = " ".join(capsys.readouterr().err.split())
    assert f"{flag} is not ported: {' '.join(why.split())}" in err
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"{flag.lstrip('-')}: {'true' if not value else 1}\n")
    with pytest.raises(SystemExit):
        port_run.parse_args(["-np", "2", "--config-file", str(cfg),
                             "python", "t.py"])
    assert "is not ported" in capsys.readouterr().err


def test_torch_runner_forwards_only_what_the_port_reads(monkeypatch):
    """Every forwarded variable round-trips into the port's Config."""
    from horovod_tpu_torch.common.config import Config
    args = port_run.parse_args([
        "-np", "2", "--fusion-threshold-mb", "8", "--cycle-time-ms", "2",
        "--max-inflight", "3", "--spec-ready-after", "4",
        "--round-pipeline", "2", "--stall-check-time", "9",
        "--stall-shutdown-time", "0", "--round-timeout", "20",
        "--connect-retries", "5", "--connect-backoff-ms", "100",
        "python", "t.py"])
    env = port_run.tuning_env(args)
    assert len(env) == len(port_run._TUNING)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    assert (cfg.fusion_threshold_bytes, cfg.cycle_time_ms, cfg.max_inflight,
            cfg.spec_ready_after, cfg.round_pipeline, cfg.stall_check_time_s,
            cfg.round_timeout_s, cfg.connect_retries,
            cfg.connect_backoff_ms) == (8 << 20, 2.0, 3, 4, 2, 9.0, 20.0, 5,
                                        100.0)


# ---------------------------------------------------------- observability
# The seven observability flags the port once refused: flag, its value on
# the command line (none for a switch), the variable it forwards, what a
# rank gets there (``{r}`` its rank), and the port Config's field and value.
OBSERVE_FLAGS = {
    "--monitor": ([], "HOROVOD_MONITOR", "1", "monitor", True),
    "--monitor-port": (["9123"], "HOROVOD_MONITOR_PORT", "9123",
                       "monitor_port", 9123),
    "--monitor-interval": (["0.5"], "HOROVOD_MONITOR_INTERVAL", "0.5",
                           "monitor_interval_s", 0.5),
    "--trace-filename": (["/tmp/hvd/tr"], "HOROVOD_TRACE", "/tmp/hvd/tr.{r}",
                         "trace_filename", "/tmp/hvd/tr.{r}"),
    "--trace-ring": (["512"], "HOROVOD_TRACE_RING", "512", "trace_ring",
                     512),
    "--timeline-filename": (["/tmp/hvd/tl"], "HOROVOD_TIMELINE",
                            "/tmp/hvd/tl.{r}", "timeline_filename",
                            "/tmp/hvd/tl.{r}"),
    "--timeline-mark-cycles": ([], "HOROVOD_TIMELINE_MARK_CYCLES", "1",
                               "timeline_mark_cycles", True),
}


@pytest.mark.parametrize("flag", sorted(OBSERVE_FLAGS))
def test_torch_runner_forwards_observability_flag(flag, monkeypatch):
    """Each flag the port no longer refuses parses, forwards the JAX
    launcher's variable to every rank with the JAX launcher's value (the
    file names per rank, ``<base>.<rank>``), and round-trips into the
    port's Config.  ``--monitor-port`` also arms the monitor, as there."""
    from horovod_tpu_torch.common.config import Config
    value, var, want, field, cfg_want = OBSERVE_FLAGS[flag]
    assert flag not in port_run.NOT_PORTED
    argv = ["-np", "3", "-H", "a:2,b:1", flag, *value, "python", "t.py"]
    coord = ("1.2.3.4", 5555, 5556)
    envs = {}
    for pkg in RUNNERS:
        run = _mod(pkg)
        args = run.parse_args(argv)
        envs[pkg] = run.worker_envs(args, run.placement(args), coord)
    for r, (jenv, penv) in enumerate(zip(*envs.values())):
        assert penv[var] == jenv[var] == want.format(r=r)
        if flag == "--monitor-port":
            assert penv["HOROVOD_MONITOR"] == jenv["HOROVOD_MONITOR"] == "1"
        for k in [k for k in penv if k.startswith("HOROVOD_")
                  and "CONTROLLER" not in k and k != "HOROVOD_LOCAL_COUNTS"]:
            monkeypatch.setenv(k, penv[k])
        got = getattr(Config.from_env(), field)
        assert got == (cfg_want.format(r=r) if isinstance(cfg_want, str)
                       else cfg_want)
        if flag == "--trace-filename":
            assert Config.from_env().trace is True
        for k in penv:
            monkeypatch.delenv(k, raising=False)
    plain = port_run.parse_args(["-np", "2", "python", "t.py"])
    assert var not in port_run.worker_envs(plain, port_run.placement(plain),
                                           coord)[0]


# ---------------------------------------------------------- serving plane
# The two serving flags the port once refused: flag, its value on the
# command line (none for a switch), the variable it forwards, its value
# there, and the port Config's field and value.
SERVE_FLAGS = {
    "--serve": ([], "HOROVOD_SERVE", "1", "serve", True),
    "--serve-port": (["8500"], "HOROVOD_SERVE_PORT", "8500", "serve_port",
                     8500),
}


def _elastic_env(monkeypatch, argv):
    """The env the port's elastic path hands its driver for ``argv``
    (the driver itself is replaced: nothing is spawned)."""
    from horovod_tpu_torch.elastic import driver as elastic_driver
    seen = {}

    class Driver:
        def __init__(self, discovery, command, env=None, **kw):
            seen.update(env)
            self.rendezvous = type("R", (), {"stop": lambda self: None})()

        def run(self):
            return 0

    monkeypatch.setattr(elastic_driver, "ElasticDriver", Driver)
    assert port_run.main(["--host-discovery-script", "echo localhost:2",
                          "--min-np", "1", "--max-np", "2", *argv]) == 0
    return seen


@pytest.mark.parametrize("path", ["static", "elastic"])
@pytest.mark.parametrize("flag", sorted(SERVE_FLAGS))
def test_torch_runner_forwards_serve_flag(flag, path, monkeypatch):
    """``--serve`` and ``--serve-port`` parse and reach every worker's env
    on both launch paths, the static one (``worker_envs``, beside the JAX
    launcher's, which sends the same variable and value) and the elastic
    one (the env its driver gives each worker), and round-trip into the
    port's Config, from which a rank takes its front door's port
    (``serve_port + rank``); without the flag the variable is absent."""
    from horovod_tpu_torch.common.config import Config
    value, var, want, field, cfg_want = SERVE_FLAGS[flag]
    assert flag not in port_run.NOT_PORTED
    argv = [flag, *value, "python", "t.py"]
    if path == "static":
        argv = ["-np", "3", "-H", "a:2,b:1", *argv]
        coord = ("1.2.3.4", 5555, 5556)
        envs = {}
        for pkg in RUNNERS:
            run = _mod(pkg)
            args = run.parse_args(argv)
            envs[pkg] = run.worker_envs(args, run.placement(args), coord)
        got = []
        for jenv, penv in zip(*envs.values()):
            assert penv[var] == jenv[var] == want
            got.append(penv[var])
        plain = port_run.parse_args(["-np", "2", "python", "t.py"])
        assert var not in port_run.worker_envs(
            plain, port_run.placement(plain), coord)[0]
    else:
        got = [_elastic_env(monkeypatch, argv)[var]]
        assert got == [want]
        assert var not in _elastic_env(monkeypatch, ["python", "t.py"])
    for v in got:
        monkeypatch.setenv(var, v)
        assert getattr(Config.from_env(), field) == cfg_want
        monkeypatch.delenv(var)
    assert getattr(Config.from_env(), field) == getattr(Config(), field)


# ------------------------------------------------- the two-level data plane
_HIER_FLAGS = ("--hierarchical-allreduce", "--hierarchical-allgather",
               "--hierarchical-broadcast")
# ------------------------------------------------------- sharded optimizer
# The three sharded-optimizer flags the port once refused: flag, its value
# on the command line (none for a switch), the variable it forwards, its
# value there, and the port Config's field and value.
ZERO_FLAGS = {
    "--sharded": ([], "HOROVOD_SHARDED_OPTIMIZER", "1", "sharded_optimizer",
                  True),
    "--sharded-params": ([], "HOROVOD_SHARDED_PARAMS", "1",
                         "sharded_params", True),
    "--prefetch-depth": (["3"], "HOROVOD_PREFETCH_DEPTH", "3",
                         "prefetch_depth", 3),
}


@pytest.mark.parametrize("flag", sorted(ZERO_FLAGS))
def test_torch_runner_forwards_sharded_flag(flag, monkeypatch):
    """Each sharded-optimizer flag parses, reaches every rank with the JAX
    launcher's variable and value (``worker_envs``; the flags ride the
    negotiation digest, so every rank must get them), and round-trips
    into the port's Config, where ``DistributedOptimizer`` reads its
    default; without the flag the variable is absent and the Config's
    default holds."""
    from horovod_tpu_torch.common.config import Config
    value, var, want, field, cfg_want = ZERO_FLAGS[flag]
    assert flag not in port_run.NOT_PORTED
    argv = ["-np", "3", "-H", "a:2,b:1", flag, *value, "python", "t.py"]
    coord = ("1.2.3.4", 5555, 5556)
    envs = {}
    for pkg in RUNNERS:
        run = _mod(pkg)
        args = run.parse_args(argv)
        envs[pkg] = run.worker_envs(args, run.placement(args), coord)
    for jenv, penv in zip(*envs.values()):
        assert penv[var] == jenv[var] == want
        monkeypatch.setenv(var, penv[var])
        assert getattr(Config.from_env(), field) == cfg_want
        monkeypatch.delenv(var)
    plain = port_run.parse_args(["-np", "2", "python", "t.py"])
    assert var not in port_run.worker_envs(plain, port_run.placement(plain),
                                           coord)[0]
    assert getattr(Config.from_env(), field) == getattr(Config(), field)


def test_torch_runner_still_refuses_pipeline_chunk(monkeypatch):
    """``--pipeline-chunk-mb`` is forwarded now that the engine pipelines
    its chunks (the name is older than the feature): beside ``--sharded``
    it reaches every rank as ``HOROVOD_PIPELINE_CHUNK`` in bytes, as the
    JAX launcher sends it, and the port's Config reads it back."""
    from horovod_tpu_torch.common.config import Config
    argv = ["-np", "2", "--sharded", "--pipeline-chunk-mb", "4", "python",
            "t.py"]
    args = port_run.parse_args(argv)
    env = port_run.worker_envs(args, port_run.placement(args),
                               ("1.2.3.4", 5555, 5556))[1]
    jargs = _mod(RUNNERS[0]).parse_args(argv)
    assert env["HOROVOD_PIPELINE_CHUNK"] == str(4 << 20) == \
        _mod(RUNNERS[0]).tuning_env(jargs)["HOROVOD_PIPELINE_CHUNK"]
    monkeypatch.setenv("HOROVOD_PIPELINE_CHUNK", env["HOROVOD_PIPELINE_CHUNK"])
    assert Config.from_env().pipeline_chunk_bytes == 4 << 20


# ------------------------------------------------------- data-plane depth
# The five data-plane depth flags the port once refused: flag, its value
# on the command line (none for a switch), the variable it forwards, its
# value there, and the port Config's field and value.
DEPTH_FLAGS = {
    "--pipeline-chunk-mb": (["64"], "HOROVOD_PIPELINE_CHUNK",
                            str(64 << 20), "pipeline_chunk_bytes", 64 << 20),
    "--fast-lane-threshold-kb": (["64"], "HOROVOD_FAST_LANE_THRESHOLD",
                                 str(64 << 10), "fast_lane_threshold_bytes",
                                 64 << 10),
    "--partition-threshold-mb": (["0.5"], "HOROVOD_PARTITION_THRESHOLD",
                                 str(1 << 19), "partition_threshold_bytes",
                                 1 << 19),
    "--autotune": ([], "HOROVOD_AUTOTUNE", "1", "autotune", True),
    "--autotune-log-file": (["/tmp/hvd/tune.csv"], "HOROVOD_AUTOTUNE_LOG",
                            "/tmp/hvd/tune.csv", "autotune_log",
                            "/tmp/hvd/tune.csv"),
}


@pytest.mark.parametrize("flag", sorted(DEPTH_FLAGS))
def test_torch_runner_forwards_depth_flag(flag, monkeypatch):
    """Each data-plane depth flag parses, reaches every rank with the JAX
    launcher's variable and value (the log file only beside
    ``--autotune``, as there), and round-trips into the port's Config;
    without the flag the variable is absent and the Config's default
    holds."""
    from horovod_tpu_torch.common.config import Config
    value, var, want, field, cfg_want = DEPTH_FLAGS[flag]
    assert flag not in port_run.NOT_PORTED
    extra = ["--autotune"] if flag == "--autotune-log-file" else []
    argv = ["-np", "3", "-H", "a:2,b:1", *extra, flag, *value, "python",
            "t.py"]
    coord = ("1.2.3.4", 5555, 5556)
    envs = {}
    for pkg in RUNNERS:
        run = _mod(pkg)
        args = run.parse_args(argv)
        envs[pkg] = run.worker_envs(args, run.placement(args), coord)
    for jenv, penv in zip(*envs.values()):
        assert penv[var] == jenv[var] == want
        monkeypatch.setenv(var, penv[var])
        assert getattr(Config.from_env(), field) == cfg_want
        monkeypatch.delenv(var)
    plain = port_run.parse_args(["-np", "2", "python", "t.py"])
    assert var not in port_run.worker_envs(plain, port_run.placement(plain),
                                           coord)[0]
    assert getattr(Config.from_env(), field) == getattr(Config(), field)


_HIER_VARS = ("HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLGATHER",
              "HOROVOD_HIERARCHICAL_BROADCAST")


def test_torch_runner_forwards_hierarchical_flags(run):
    """The three ``--hierarchical-*`` flags reach every worker as
    ``HOROVOD_HIERARCHICAL_*=1`` on both launchers, and none without
    them."""
    args = run.parse_args(["-np", "4", "-H", "a:2,b:2", *_HIER_FLAGS,
                           "python", "t.py"])
    envs = run.worker_envs(args, run.placement(args),
                           ("1.2.3.4", 5555, 5556))
    for env in [run.tuning_env(args)] + envs:
        assert all(env[v] == "1" for v in _HIER_VARS)
    plain = run.parse_args(["-np", "2", "python", "t.py"])
    assert not set(_HIER_VARS) & set(run.tuning_env(plain))


def test_torch_runner_hierarchical_flags_reach_the_config(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    args = port_run.parse_args(["-np", "4", *_HIER_FLAGS, "python", "t.py"])
    for k, v in port_run.tuning_env(args).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", "2")
    monkeypatch.setenv("HOROVOD_HIER_THRESHOLD", "4096")
    monkeypatch.setenv("HOROVOD_SLICE_MAP", "2,2")
    cfg = Config.from_env()
    assert (cfg.hierarchical_allreduce, cfg.hierarchical_allgather,
            cfg.hierarchical_broadcast, cfg.hierarchical_local_size,
            cfg.hier_threshold_bytes, cfg.slice_map) == (
        True, True, True, 2, 4096, "2,2")


def test_torch_runner_still_refuses_the_hierarchical_controller():
    """``--hierarchical-controller`` on both launchers (the counterpart of
    ``test_worker_envs_hierarchical_controller``): the knob is forwarded
    through ``tuning_env``, one agent port a host is injected, the same on
    every process of the host, and nothing is refused."""
    assert "--hierarchical-controller" not in port_run.NOT_PORTED
    for run in map(_mod, RUNNERS):
        args = run.parse_args(["-np", "4", "-H", "a:2,b:2",
                               "--hierarchical-controller", "python",
                               "t.py"])
        assert run.tuning_env(args)["HOROVOD_HIERARCHICAL_CONTROLLER"] == "1"
        coord = ("1.2.3.4", 5555, 5556)
        envs = run.worker_envs(args, run.placement(args), coord,
                               agent_ports=[7001, 7002])
        assert [e["HOROVOD_AGENT_PORT"] for e in envs] == \
            ["7001", "7001", "7002", "7002"]
        assert all(e["HOROVOD_HIERARCHICAL_CONTROLLER"] == "1" for e in envs)
        remote = run.worker_envs(args, run.placement(args), coord,
                                 agent_ports=[7001, None])
        assert "HOROVOD_AGENT_PORT" not in remote[2]


@pytest.mark.parametrize("hosts,np_,counts", [
    ("a:2,b:1,c:3", 6, "2,1,3"), ("a:2,b:2", 3, "2,1"),
    ("localhost:4", 4, "4"), ("a:1,b:1,c:1,d:1", 4, "1,1,1,1")])
def test_torch_runner_gives_every_rank_the_ranks_per_host(hosts, np_,
                                                          counts):
    """``HOROVOD_LOCAL_COUNTS`` beside ``HOROVOD_CROSS_SIZE``: the ranks of
    each host entry in host order, the same list on every rank, from
    which each derives the slices alike (``common/topology.py``)."""
    args = port_run.parse_args(["-np", str(np_), "-H", hosts, "python",
                                "t.py"])
    envs = port_run.worker_envs(args, port_run.placement(args),
                                ("1.2.3.4", 5555, 5556))
    assert [e["HOROVOD_LOCAL_COUNTS"] for e in envs] == [counts] * np_


def test_torch_runner_spawns_every_local_entry_locally(tmp_path,
                                                       monkeypatch):
    """Four entries that all name this machine (``localhost``,
    ``127.0.0.1``, ``127.0.0.2``, ``127.0.0.3``: four ranks on one card,
    each with its own NCCL host id) are spawned here, not over ssh: the
    launcher asks ``common/net.is_local_host``, as its bootstrap does."""
    def no_ssh(*a, **k):
        raise AssertionError(f"ssh for a local entry: {a}")
    monkeypatch.setattr(port_run, "ssh_command", no_ssh)
    out = tmp_path / "o"
    script = tmp_path / "w.py"
    script.write_text(
        "import os\n"
        "print(os.environ['HOROVOD_RANK'], os.environ['HOROVOD_HOSTNAME'],"
        " os.environ['HOROVOD_LOCAL_COUNTS'], os.environ['NCCL_HOSTID'])\n")
    hosts = "localhost:1,127.0.0.1:1,127.0.0.2:1,127.0.0.3:1"
    args = port_run.parse_args(["-np", "4", "-H", hosts,
                                "--output-filename", str(out),
                                sys.executable, str(script)])
    assert port_run.launch_workers(args, port_run.placement(args)) == 0
    seen = [(out / f"rank.{r}" / "stdout").read_text().split()
            for r in range(4)]
    assert [s[:3] for s in seen] == [
        [str(r), h.split(":")[0], "1,1,1,1"]
        for r, h in enumerate(hosts.split(","))]
    assert len({s[3] for s in seen}) == 4
