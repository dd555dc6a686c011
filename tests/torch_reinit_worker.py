"""One rank of a world that calls ``init()`` again after ``shutdown()``, for
``tests/test_torch_reinit.py``.

Run under a launcher (``python -m horovod_tpu_torch.runner -np 2`` for
``port``, ``python -m horovod_tpu.runner.launch -np 2`` for ``ref``)::

    python tests/torch_reinit_worker.py {port|ref} OUT_DIR [--gens N]
    python tests/torch_reinit_worker.py port OUT_DIR --examples NAME,...
    python tests/torch_reinit_worker.py port OUT_DIR --fault

The first form runs N generations, each ``init()``, the collectives of
:func:`_collectives` on seeded numpy inputs, ``shutdown()``; each rank
writes ``OUT_DIR/rank<r>.npz`` with every result and ``rank<r>.json`` with
every generation's auto-generated collective names (the reference's
ranks meet after each ``shutdown()``: :func:`_both_shut_down`).  The
port's run also
records the process groups alive after each ``shutdown()``
(``torch.distributed``'s ``pg_map``) and whether a mesh and a process set
of generation 0 raise in generation 1.  With ``REINIT_TEST_STAGGER_S`` in
its environment, rank 0 (or the rank ``REINIT_TEST_STAGGER_RANK`` names)
sleeps that long before each ``shutdown()``, so that the other rank
re-inits while it is still in the last generation.

The second form runs the port's examples, each through its ``main(argv)``
with ``--cpu`` (each example inits and shuts down itself), in turn in one
world, and writes each one's losses and parameters to
``OUT_DIR/<name>.rank<r>.npz``.  The third plants a peer fault
(:func:`run_fault`).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAGGER_ENV = "REINIT_TEST_STAGGER_S"
STAGGER_RANK_ENV = "REINIT_TEST_STAGGER_RANK"

# The examples at the CPU sizes of tests/test_torch_examples_*.py.
EXAMPLE_ARGS = {
    "resnet_synthetic": ["--depth", "18", "--image-size", "32", "--fp32",
                         "--num-warmup", "1", "--num-iters", "2"],
    "torch_mnist": ["--epochs", "1"],
    "llama_spmd": ["--tiny", "--tp", "2", "--steps", "2"],
}


def _inputs(gen, rank, size):
    """The generation's seeded inputs of this rank (float32)."""
    rs = np.random.RandomState(1000 * gen + rank)
    f = np.float32
    return dict(
        sum=rs.standard_normal((4, 5)).astype(f),
        avg=rs.standard_normal((6,)).astype(f),
        gather=rs.standard_normal((2, 3)).astype(f),
        bcast=rs.standard_normal((3, 2)).astype(f),
        a2a=rs.standard_normal((size * 2, 4)).astype(f),
        rs=rs.standard_normal((size * 3, 2)).astype(f),
        ps=rs.standard_normal((5,)).astype(f),
        tail=rs.standard_normal((2,)).astype(f))


class _Port:
    """The port's calls on numpy in and out, on the CPU (gloo)."""

    def __init__(self):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import eager
        self.hvd, self.eager = hvd, eager

    def init(self):
        self.hvd.init(device="cpu")

    def run(self, fn, x, **kw):
        import torch
        out = getattr(self.hvd, fn)(torch.from_numpy(x), **kw)
        if isinstance(out, tuple):          # the ragged alltoall
            out = out[0]
        return out.numpy()


class _Ref:
    """The JAX package's calls in per-process mode."""

    def __init__(self):
        os.environ["XLA_FLAGS"] = " ".join(
            f for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f)
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        import horovod_tpu as hvd
        from horovod_tpu.ops import eager
        self.hvd, self.eager = hvd, eager

    def init(self):
        self.hvd.init()

    def run(self, fn, x, **kw):
        out = getattr(self.hvd, fn)(x, **kw)
        if isinstance(out, tuple):
            out = out[0]
        out = np.asarray(self.hvd.to_local(out))
        # The reducescatter's local result keeps the stacked rank axis
        # ([1, rows, ...]); the port's is this rank's rows.
        return out[0] if fn == "reducescatter" else out


def _collectives(api, gen, rank, size):
    """One generation's collectives, every name auto-generated; returns
    ``{key: result}`` and the generation's process sets."""
    hvd = api.hvd
    x = _inputs(gen, rank, size)
    out = {
        "sum": api.run("allreduce", x["sum"], op=hvd.Sum),
        "avg": api.run("allreduce", x["avg"], op=hvd.Average),
        "gather": api.run("allgather", x["gather"]),
        "bcast": api.run("broadcast", x["bcast"], root_rank=1),
        "a2a": api.run("alltoall", x["a2a"],
                       splits=np.asarray([1, 3] if rank == 0 else [3, 1])),
        "rs": api.run("reducescatter", x["rs"], op=hvd.Sum),
    }
    # A set of one rank a rank, added in this generation (a set of both
    # ranks would be the global set's twin, which both packages refuse).
    sets = [hvd.add_process_set([r]) for r in range(size)]
    out["ps"] = api.run("allreduce", x["ps"], op=hvd.Sum,
                        process_set=sets[rank])
    # A last world collective: no rank leaves while the other still
    # negotiates its set's.
    out["tail"] = api.run("allreduce", x["tail"], op=hvd.Sum)
    return out, sets


def _groups():
    from torch.distributed import distributed_c10d as c10d
    return len(c10d._world.pg_map)


def run_generations(which, out_dir, gens):
    api = _Port() if which == "port" else _Ref()
    names = []
    auto_name = api.eager._auto_name

    def recording(prefix, name):
        got = auto_name(prefix, name)
        if not name:
            names[-1].append(got)
        return got

    api.eager._auto_name = recording
    results, extra = {}, {"groups": [], "stale": {}, "agent": []}
    if which == "port":
        from horovod_tpu_torch.common import basics
    stagger = float(os.environ.get(STAGGER_ENV, "0") or 0)
    late = int(os.environ.get(STAGGER_RANK_ENV, "0") or 0)
    stale = {}
    for gen in range(gens):
        names.append([])
        api.init()
        rank, size = api.hvd.rank(), api.hvd.size()
        out, sets = _collectives(api, gen, rank, size)
        for k, v in out.items():
            results[f"g{gen}.{k}"] = v
        if which == "port":
            _port_stale(api.hvd, gen, sets, stale, extra["stale"])
        if which == "port":
            extra["agent"].append(
                basics._get_state().host_agent is not None)
        if stagger and rank == late:
            time.sleep(stagger)
        api.hvd.shutdown()
        if which == "port":
            extra["groups"].append(_groups())
        else:
            _both_shut_down(out_dir, gen, rank, size)
    if which == "port":
        extra["refused"] = _port_refuses_another_rank(api.hvd, rank, size)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(dict(names=names, **extra), fh)


def _both_shut_down(out_dir, gen, rank, size, timeout_s=60.0):
    """A barrier through files in ``out_dir``: returns once every rank has
    shut generation ``gen`` down.  The JAX package's world runs so: a rank
    that re-inits while its peer is still shutting down sometimes fails
    its next round there (HVD303, then a hang; about 1 launch in 6 on a
    CPU), and the reference's results must not depend on that race."""
    open(os.path.join(out_dir, f".down.g{gen}.r{rank}"), "w").close()
    deadline = time.time() + timeout_s
    while not all(os.path.exists(os.path.join(out_dir, f".down.g{gen}.r{r}"))
                  for r in range(size)):
        if time.time() > deadline:
            raise TimeoutError(f"generation {gen}: not every rank shut down "
                               f"within {timeout_s:g} s")
        time.sleep(0.01)


def _port_stale(hvd, gen, sets, made, seen):
    """Generation 0 makes a mesh and leaves it and its process sets to
    ``shutdown()``; generation 1 finds that the mesh and a set raise, and
    makes a mesh that it shuts down itself before ``shutdown()``."""
    import torch
    from horovod_tpu_torch import parallel
    if gen == 0:
        made["mesh"] = parallel.make_mesh({"dp": hvd.size()})
        made["set"] = sets[hvd.rank()]
    elif gen == 1:
        for key, call in (
                ("mesh", lambda: made["mesh"].axis("dp")),
                ("set", lambda: hvd.allreduce(torch.ones(2), name="stale",
                                              process_set=made["set"]))):
            try:
                call()
                seen[key] = "ran"
            except (RuntimeError, ValueError) as exc:
                seen[key] = type(exc).__name__
        made["mesh"].shutdown()
        mesh = parallel.make_mesh({"dp": hvd.size()})
        mesh.shutdown()


def run_fault(out_dir):
    """A planted peer fault in a static world of two: rank 1 dies after
    the first allreduce; rank 0's next allreduce fails, it shuts down and
    calls ``init()`` again, which must raise at once.  Rank 0 writes
    ``fault.json``: the allreduce's error, ``init()``'s error and its
    seconds."""
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank = hvd.rank()
    hvd.allreduce(torch.ones(4), name="before")
    if rank == 1:
        os._exit(13)
    seen = {}
    try:
        hvd.allreduce(torch.ones(4), name="after")
        seen["allreduce"] = "ran"
    except Exception as exc:  # noqa: BLE001 - the error is the result
        seen["allreduce"] = type(exc).__name__
    hvd.shutdown()
    t0 = time.time()
    try:
        hvd.init(device="cpu")
        seen["init"] = "ran"
    except RuntimeError as exc:
        seen["init"], seen["message"] = type(exc).__name__, str(exc)
    seen["init_s"] = time.time() - t0
    with open(os.path.join(out_dir, "fault.json"), "w") as fh:
        json.dump(seen, fh)


def _port_refuses_another_rank(hvd, rank, size):
    """``init()`` on the kept world with the env naming the other rank:
    the error's text, or "ran"."""
    os.environ["HOROVOD_RANK"] = str(size - 1 - rank)
    try:
        hvd.init(device="cpu")
        return "ran"
    except RuntimeError as exc:
        return str(exc)
    finally:
        os.environ["HOROVOD_RANK"] = str(rank)


def run_examples(out_dir, names):
    import importlib

    import torch
    for name in names:
        mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
        out = mod.main([*EXAMPLE_ARGS[name], "--cpu"])
        if name == "torch_mnist":
            named = list(out["model"].named_parameters())
        elif name == "llama_spmd":
            named = out["named"]
        else:
            from horovod_tpu_torch.models import llama
            named = list(llama.named_parameters(out["params"]))
        state = {f"p.{k}": t.detach().to(torch.float32).numpy()
                 for k, t in named}
        rank = os.environ["HOROVOD_RANK"]
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                 losses=np.asarray(out["losses"], np.float64), **state)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=("port", "ref"))
    p.add_argument("out")
    p.add_argument("--gens", type=int, default=3)
    p.add_argument("--examples", default="")
    p.add_argument("--fault", action="store_true")
    args = p.parse_args()
    if args.fault:
        run_fault(args.out)
    elif args.examples:
        run_examples(args.out, args.examples.split(","))
    else:
        run_generations(args.which, args.out, args.gens)


if __name__ == "__main__":
    main()
