# Ported from examples/dlrm_alltoall.py:1-94.
"""DLRM-style model-parallel embedding exchange with ragged
``hvd.alltoall``.

The embedding table is sharded by hash across ranks, so every step each
rank

  1. hashes its local batch's ids to their owner ranks,
  2. ships the id lists out with one ragged alltoall (uneven row counts),
  3. looks up its own table shard for every id it received,
  4. ships the embedding rows back with a second ragged alltoall whose
     splits are the first exchange's received splits.

Both exchanges go through the port's collective engine (negotiation,
then one ``all_to_all_single`` a batch).  The in-model variant, the
tables split over the mesh's ``ep`` axis, is
``horovod_tpu_torch/models/dlrm.py``.

Run::

    python -m horovod_tpu_torch.runner -np 2 \\
        python -m horovod_tpu_torch.examples.dlrm_alltoall
    # on the CPU, over gloo:
    python -m horovod_tpu_torch.runner -np 2 \\
        python -m horovod_tpu_torch.examples.dlrm_alltoall --cpu --steps 2
"""

import argparse


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--vocab", type=int, default=1000,
                   help="global embedding rows (hash-sharded across ranks)")
    p.add_argument("--dim", type=int, default=16, help="embedding dim")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo (default: the card)")
    return p.parse_args()


def main():
    args = parse_args()

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu" if args.cpu else None)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    rng = np.random.RandomState(rank)

    # This rank's table shard: rows whose id % size == rank.
    local_rows = (args.vocab + size - 1 - rank) // size
    table = torch.from_numpy(
        rng.randn(local_rows, args.dim).astype(np.float32) * 0.01).to(dev)

    for step in range(args.steps):
        ids = rng.randint(0, args.vocab, size=(args.batch_size,))

        # Group this batch's ids by owner rank: row counts per destination
        # are uneven, which is what the ragged form exists for.
        owner = ids % size
        order = np.argsort(owner, kind="stable")
        send_ids, splits = ids[order], np.bincount(owner, minlength=size)

        # Exchange 1: id lists to their owners.
        recv_ids, recv_splits = hvd.alltoall(
            torch.from_numpy(send_ids.astype(np.int32)).to(dev),
            splits=splits.astype(np.int32).tolist(), name=f"ids.{step}")

        # Local lookup: global id -> local row of this rank's shard.
        rows = table[recv_ids.long() // size]

        # Exchange 2: embedding rows back; the return splits are exactly
        # what was received, so each rank gets the rows of its own batch.
        back, _ = hvd.alltoall(rows, splits=[int(s) for s in recv_splits],
                               name=f"emb.{step}")

        # Undo the owner-grouping permutation to restore batch order.
        emb = torch.empty_like(back)
        emb[torch.from_numpy(order).to(dev)] = back
        assert emb.shape == (args.batch_size, args.dim)

        if rank == 0:
            print(f"step {step}: exchanged "
                  f"{int(np.sum(splits))}->{int(sum(recv_splits))} ids, "
                  f"emb norm={emb.norm().item():.4f}", flush=True)

    if rank == 0:
        print("DONE", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
