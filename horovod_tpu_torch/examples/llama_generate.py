# Ported from examples/llama_generate.py:1-134.
"""Inference on the flagship Llama: prefill through the flash forward, then
KV-cache decode, greedy, sampled or speculative.

- **prefill**: the prompt runs through each layer once with causal flash
  attention while the KV cache fills;
- **KV-cache decode**: one step a token against the cache;
- **sampling**: greedy by default; ``--temperature``/``--top-p``/
  ``--top-k`` switch to nucleus / top-k sampling from a seeded generator;
- **tensor parallelism**: ``--tp N`` under the launcher, one process a
  rank: heads split over tp, the sum at the output projection, each rank's
  kv heads in its cache (``llama.cache_specs``), the training's Megatron
  contract;
- **speculative decoding**: ``--n-draft K`` (one process, greedy): a draft
  model proposes K tokens a round and the target verifies them in one
  ``decode_chunk``; the output is the target's greedy decode.

Run::

    python -m horovod_tpu_torch.examples.llama_generate --n-tokens 32
    python -m horovod_tpu_torch.examples.llama_generate --n-draft 4
    python -m horovod_tpu_torch.runner -np 2 \\
        python -m horovod_tpu_torch.examples.llama_generate --tp 2 \\
        --temperature 0.8 --top-p 0.9

CPU smoke (gloo for tp)::

    python -m horovod_tpu_torch.examples.llama_generate --tiny --cpu \\
        --n-draft 3 --n-tokens 8
"""

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree for decode (the launcher's "
                        "world size)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--n-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples")
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--n-draft", type=int, default=0,
                   help=">0 = greedy speculative decoding with this many "
                        "draft tokens per verify round (tp/sampling off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for smoke tests")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (gloo for tp; default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama

    if args.n_draft > 0 and (args.tp > 1 or args.temperature > 0):
        raise SystemExit("--n-draft runs on one process, greedy")
    hvd.init(device="cpu" if args.cpu else None)
    dev = hvd.device()
    if hvd.size() != args.tp:
        raise SystemExit(f"--tp {args.tp} needs a world of {args.tp} "
                         f"processes (the launcher's -np), have "
                         f"{hvd.size()}")
    kw = dict(dp_axis=None, sp_axis=None,
              tp_axis="tp" if args.tp > 1 else None)
    if args.tiny:
        cfg = llama.tiny(n_heads=4, n_kv_heads=2, d_model=64, d_ff=128,
                         vocab_size=256, max_seq=128, dtype=torch.float32,
                         **kw)
    else:
        cfg = llama.LlamaConfig(vocab_size=32000, d_model=1024, n_layers=8,
                                n_heads=16, n_kv_heads=8, d_ff=4096,
                                max_seq=4096, dtype=torch.bfloat16, **kw)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params = llama.init_params(cfg, seeded(args.seed))
    prompt = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    budget = args.prompt_len + args.n_tokens

    if args.n_draft > 0:
        # A draft initialized apart from the target: the output is still
        # the target's greedy decode, the draft changes only how many
        # target forwards it takes.
        draft = llama.init_params(cfg, seeded(args.seed + 7))
        llama.speculative_generate.rounds = 0
        t0 = time.time()
        out = llama.speculative_generate(params, draft, prompt,
                                         args.n_tokens, cfg,
                                         n_draft=args.n_draft)
        wall = time.time() - t0
        print(f"generated [{args.batch}, {args.n_tokens}] tokens "
              f"speculative(n_draft={args.n_draft}) in {wall:.2f}s, "
              f"{llama.speculative_generate.rounds} rounds")
        print(out.cpu().numpy())
        print(f"DONE tokens={out.numel()}")
        hvd.shutdown()
        return

    mesh = None
    if args.tp > 1:
        mesh = parallel.make_mesh({"tp": args.tp})
        params = llama.shard_params(params, cfg, mesh)
    t0 = time.time()
    out = llama.generate(params, prompt, args.n_tokens, cfg, max_seq=budget,
                         temperature=args.temperature, top_p=args.top_p,
                         top_k=args.top_k,
                         generator=seeded(args.seed + 1), mesh=mesh)
    wall = time.time() - t0
    mode = (f"sampled(T={args.temperature}, top_p={args.top_p}, "
            f"top_k={args.top_k})" if args.temperature > 0 else "greedy")
    if hvd.rank() == 0:
        print(f"generated [{args.batch}, {args.n_tokens}] tokens, "
              f"tp={args.tp} {mode} in {wall:.2f}s")
        print(out.cpu().numpy())
        print(f"DONE tokens={out.numel()}")
    if mesh is not None:
        mesh.shutdown()
    hvd.shutdown()


if __name__ == "__main__":
    main()
