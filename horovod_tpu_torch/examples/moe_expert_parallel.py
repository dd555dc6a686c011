# Ported from examples/moe_expert_parallel.py:1-81.
"""Mixture-of-experts training with expert parallelism over the ep axis.

The all-to-all exchange of the reference's DLRM embedding config
(``hvd.alltoall``), promoted to a full sparse layer: Switch-style top-1
routing with static capacity, the experts split over ``ep``, the dispatch
and the return trip two all-to-alls on the mesh's ``ep`` groups
(``horovod_tpu_torch/models/moe.py``).  One process a card; the replicated
leaves train through ``hvd.DistributedOptimizer``, the expert slabs through
``parallel.ExpertParallel``.

Run::

    python -m horovod_tpu_torch.runner -np 2 \\
        python -m horovod_tpu_torch.examples.moe_expert_parallel --ep 2
    # on the CPU, over gloo:
    python -m horovod_tpu_torch.runner -np 2 \\
        python -m horovod_tpu_torch.examples.moe_expert_parallel --cpu --ep 2
"""

import argparse
import time


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ep", type=int, default=2, help="expert-parallel degree")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=0, help="default 4*world")
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo (default: the card)")
    args = p.parse_args()

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama, moe
    from horovod_tpu_torch.parallel import expert

    hvd.init(device="cpu" if args.cpu else None)
    n, r, dev = hvd.size(), hvd.rank(), hvd.device()
    if n % args.ep:
        raise SystemExit(f"{n} ranks not divisible by ep={args.ep}")
    mesh = parallel.make_mesh({"dp": n // args.ep, "ep": args.ep})
    cfg = moe.MoELMConfig(
        vocab_size=256, d_model=args.d_model, n_layers=2,
        moe=moe.MoEConfig(d_model=args.d_model, d_ff=4 * args.d_model,
                          n_experts=args.experts, ep_axis="ep"),
        dp_axis="dp")
    specs = moe.lm_param_specs(cfg)
    params = expert.shard_tree(
        moe.lm_init(cfg, torch.Generator(device=dev).manual_seed(0)), specs,
        mesh.index("ep"), args.ep)
    named = list(llama.named_parameters(params))
    replicated, sharded = expert.split_named(named, specs)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam([t for _, t in replicated], lr=1e-3),
        named_parameters=replicated)
    experts = expert.ExpertParallel(
        mesh, torch.optim.Adam([t for _, t in sharded], lr=1e-3))
    experts.broadcast_parameters(named, specs, root_rank=0)  # hvd-lint: disable=HVD102 (over the ep sets)
    step = moe.make_train_step(cfg, opt, mesh, experts)

    batch = args.batch or 4 * n
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (batch, args.seq))
    targets = rng.randint(0, cfg.vocab_size, (batch, args.seq))
    c = batch // n
    x, y = (torch.from_numpy(a[r * c:(r + 1) * c]).to(dev)
            for a in (tokens, targets))

    step(params, x, y)
    t0 = time.time()
    for _ in range(args.steps):
        loss = step(params, x, y)
    loss = moe.psum_loss(loss, mesh).item()
    dt = time.time() - t0
    if r == 0:
        print(f"mesh=(dp={mesh.size('dp')},ep={args.ep}) "
              f"experts={args.experts} batch={batch}")
        print(f"loss={loss:.4f} "
              f"throughput={batch * args.seq * args.steps / dt:.0f} tok/s")
        print("DONE", flush=True)
    experts.shutdown()
    mesh.shutdown()
    hvd.shutdown()


if __name__ == "__main__":
    main()
