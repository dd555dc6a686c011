"""The port's counterpart of ``tests/data/worker_torch.py`` (run by
``tests/test_multiprocess.py::test_torovodrun_torch_binding``): the same
assertions, on two CPU ranks over gloo, launched by the port's launcher
``python -m horovod_tpu_torch.runner -np 2``.  The worker is written to the
test's own directory from the string below.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import torch

    import horovod_tpu_torch as hvd


    def main():
        hvd.init(device="cpu")
        rank, size = hvd.rank(), hvd.size()

        # allreduce over rank-dependent tensors
        t = torch.full((4,), float(rank + 1))
        out = hvd.allreduce(t, op=hvd.Sum, name="t_ar")
        expected = sum(float(r + 1) for r in range(size))
        assert torch.allclose(out, torch.full((4,), expected)), (out, expected)

        out = hvd.allreduce(t, op=hvd.Average, name="t_ar_avg")
        assert torch.allclose(out, torch.full((4,), expected / size))

        # broadcast from rank 1
        b = torch.full((3,), float(rank))
        hvd.broadcast_(b, root_rank=1, name="t_bc")
        assert torch.allclose(b, torch.full((3,), 1.0))

        # allgather: rank-striped rows
        g = torch.full((2, 3), float(rank))
        out = hvd.allgather(g, name="t_ag")
        assert out.shape == (2 * size, 3)
        for r in range(size):
            assert torch.allclose(out[2 * r:2 * r + 2],
                                  torch.full((2, 3), float(r)))

        # alltoall: rank r sends chunk j to rank j; receives chunk r from all
        t = torch.arange(size * 2, dtype=torch.float32) + 100 * rank
        out = hvd.alltoall(t, name="t_a2a")
        out = out.reshape(-1)
        assert out.shape == (size * 2,), out.shape
        for src in range(size):
            chunk = out[2 * src:2 * src + 2]
            expected_chunk = (torch.tensor([2.0 * rank, 2.0 * rank + 1])
                              + 100 * src)
            assert torch.allclose(chunk, expected_chunk), (rank, src, out)

        # reducescatter
        t = torch.ones(size * 2, 3) * (rank + 1)
        out = hvd.reducescatter(t, op=hvd.Sum, name="t_rs")
        out = out.reshape(-1, 3)
        assert out.shape == (2, 3), out.shape
        total = sum(r + 1 for r in range(size))
        assert torch.allclose(out, torch.full((2, 3), float(total)))

        # DistributedOptimizer: rank-dependent data -> identical averaged
        # updates
        torch.manual_seed(42)  # same init on every rank
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)

        torch.manual_seed(rank)  # per-rank batches
        for _ in range(2):
            x, y = torch.randn(8, 4), torch.randn(8, 2)
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(x), y)
            loss.backward()
            opt.step()

        # all ranks must hold identical params now
        for name, p in model.named_parameters():
            gathered = hvd.allgather(p.data.flatten().unsqueeze(0),
                                     name=f"t_check.{name}")
            for r in range(size):
                assert torch.allclose(gathered[r], gathered[0], atol=1e-6), \\
                    name

        # SyncBatchNorm with rank-dependent batches: running stats identical
        # across ranks and equal to global-batch stats.
        sbn = hvd.SyncBatchNorm(3, momentum=1.0)
        sbn.train()
        torch.manual_seed(100 + rank)
        x = torch.randn(6, 3)
        y = sbn(x)
        y.sum().backward()
        allx = hvd.allgather(x, name="t_sbn_gather")
        gm = allx.mean(0)
        assert torch.allclose(sbn.running_mean, gm, atol=1e-5), (
            sbn.running_mean, gm)
        n = allx.shape[0]
        gv = allx.var(0, unbiased=False) * n / (n - 1)
        assert torch.allclose(sbn.running_var, gv, atol=1e-5)

        # broadcast_optimizer_state parity
        adam = torch.optim.Adam(model.parameters(), lr=1e-3 * (rank + 1))
        hvd.broadcast_optimizer_state(adam, root_rank=0)
        assert adam.param_groups[0]["lr"] == 1e-3

        print(f"WORKER_OK rank={rank}")
        hvd.shutdown()


    if __name__ == "__main__":
        main()
""")


def test_torch_runner_torch_binding(tmp_path):
    script = tmp_path / "worker_torch.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=120)
    ok = res.stdout.count("WORKER_OK")
    assert res.returncode == 0 and ok == 2, (
        f"rc={res.returncode}\nstdout:\n{res.stdout[-3000:]}\n"
        f"stderr:\n{res.stderr[-3000:]}")
