#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--seed S]

Phases (any failure exits non-zero and prints no result line):

1. Card: the card's name and power limit, as nvidia-smi reports them.
2. Build: every CUDA kernel of the port from its source, in parallel.
3. Kernels against their plain PyTorch versions on the card, with the
   stated tolerances, CUDA-event times of the kernel, the plain version
   and the one-call library yardstick (``library_ms``, never used by the
   port), and the bound computed from this run's shapes.
4. Serving: ``init`` -> ``Replica.load`` -> ``ContinuousBatcher`` ->
   ``serve_loop`` at Llama-3-8B width (full depth by default), 8 requests
   of 512 prompt tokens, 16 greedy new tokens each; kernel launch counts
   are zeroed just before and read just after.  Then the prefill logits
   are recomputed with the plain attention and compared, and one prompt at
   two rows of one bucket must give identical tokens.  Last, the time of
   one prefill and one decode step, and a profiled ``generate`` for the
   card's busy share and kernel time by name.
5. The kernels line (JSON), the card line, and the result line.

It imports nothing of JAX and nothing of ``horovod_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor-core bf16
                  "float32": 67e12}     # float32 outside the tensor cores
N_REQUESTS = 8
PROMPT_LEN = 512
NEW_TOKENS = 16


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=10, warmup=3):
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, with the L2
    cache flushed before each (the serving path meets its inputs cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ------------------------------------------------------------- flash cases
# (name, B, Tq, Tk, H, K, D, dtype, causal, window, o-tolerance, reason)
_BF16_REASON = ("bf16 output rounding (2^-8 relative) plus p rounded to "
                "bf16 at a different running max in the kernel's online "
                "softmax than in the dense plain version")
_F32_REASON = ("same float32 arithmetic; sums taken in another order and "
               "exp/log from other implementations")
FLASH_CASES = [
    ("serving shape: causal GQA rep 4, bf16", 8, 512, 512, 32, 8, 128,
     "bfloat16", True, None, 2e-2, _BF16_REASON),
    ("serving shape in float32", 8, 512, 512, 32, 8, 128, "float32", True,
     None, 1e-4, _F32_REASON),
    ("non-causal cross shape Tq=300 Tk=200, D=64", 2, 300, 200, 8, 2, 64,
     "bfloat16", False, None, 2e-2, _BF16_REASON),
    ("causal sliding window 128", 2, 512, 512, 32, 8, 128, "bfloat16", True,
     128, 2e-2, _BF16_REASON),
    ("fully masked rows: Tq=300 > Tk=100 + window 64", 2, 300, 100, 8, 2,
     64, "float32", True, 64, 1e-4, _F32_REASON),
]
LSE_TOL = 1e-4   # float32 on both sides: only summation order differs


def flash_phase(torch, fa, dev, seed, flush):
    import torch.nn.functional as F
    results = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for (name, B, Tq, Tk, H, K, D, dt_name, causal, window, tol,
         reason) in FLASH_CASES:
        dt = getattr(torch, dt_name)
        q = torch.randn(B, Tq, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Tk, K, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Tk, K, D, generator=gen, device=dev).to(dt)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
        err_o = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        rel_o = err_o / max(o_p.float().abs().max().item(), 1e-30)
        rel_l = err_l / max(lse_p.abs().max().item(), 1e-30)
        mask = fa._mask(Tq, Tk, causal, window, dev)
        ok = err_o <= tol and err_l <= LSE_TOL
        empty = ~mask.any(dim=1)
        if empty.any():
            ok = ok and bool((o[:, empty] == 0).all()) \
                and bool((lse[:, :, empty] == 0).all())
        pairs = int(mask.sum().item())
        ops = 4.0 * D * pairs * B * H
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, o)) \
            + lse.numel() * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dt_name] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, window=window), flush)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        library_ms = time_ms(torch, lib, flush)
        print(f"flash[{name}] B={B} Tq={Tq} Tk={Tk} H={H} K={K} D={D} "
              f"{dt_name} causal={causal} window={window}: "
              f"o max_abs_err={err_o:.3e} max_rel_err={rel_o:.3e} "
              f"(tol {tol:g} abs: {reason}); lse max_abs_err={err_l:.3e} "
              f"max_rel_err={rel_l:.3e} (tol {LSE_TOL:g} abs: {_F32_REASON})"
              f"; empty rows {int(empty.sum())}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.1f} MB"
              f", {ops / 1e9:.2f} GFLOP) -> {'PASS' if ok else 'FAIL'}",
              flush=True)
        results.append(dict(case=name, ok=ok, max_abs_err=err_o, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, o, lse, o_p, lse_p
    return results


# ----------------------------------------------------------------- serving
def serving_phase(torch, hvd, tl, fa, layers, seed):
    import numpy as np
    from horovod_tpu_torch.serve import ContinuousBatcher, Replica

    hvd.init()
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=layers)
    if layers != 32:
        print(f"serving: depth cut to {layers} of 32 layers", flush=True)
    t0 = time.time()
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in [params["embed"], params["lm_head"]]
                   + [w for lay in params["layers"] for w in lay.values()])
    print(f"serving: llama3_8b width, {layers} layers, {n_params / 1e9:.3f}"
          f" B params bf16 on {dev} in {time.time() - t0:.1f} s", flush=True)
    prompts = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)

    def apply_fn(p, x):
        return tl.generate(p, x, NEW_TOKENS, cfg)

    replica = Replica(apply_fn)
    if not replica.load(params, version=1) or replica.load(params, 1):
        _fail("versioned load: first load must run, a repeat must not")
    # Warm-up outside the counted run (cuBLAS handles, allocator).
    tl.generate(params, torch.from_numpy(prompts[:1, :64]).to(dev), 2, cfg)
    torch.cuda.synchronize()

    batcher = ContinuousBatcher(max_batch=8, buckets=(1, 2, 4, 8),
                                max_inflight=1, deadline_ms=600000.0)
    reqs = [batcher.submit(p) for p in prompts]
    stop = threading.Event()
    fa.flash_attention_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    th = threading.Thread(target=replica.serve_loop, args=(batcher, stop),
                          daemon=True)
    th.start()
    answers = [r.wait(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.flash_attention_fwd.launches
    stop.set()
    th.join(timeout=60)
    if th.is_alive():
        _fail("serve loop did not stop")
    batches = batcher.stats()["batches_total"]
    ok_answers = sum(1 for a in answers if a.shape == (NEW_TOKENS,)
                     and a.min() >= 0 and a.max() < cfg.vocab_size)
    print(f"serving: {ok_answers}/{N_REQUESTS} answers in {wall:.3f} s "
          f"wall, {ok_answers * NEW_TOKENS} tokens generated, {batches} "
          f"batch(es), flash launches {launches} (= {layers} layers x "
          f"{batches} prefill batch(es) expected), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, card "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    ok = ok_answers == N_REQUESTS and launches == layers * batches \
        and launches > 0

    # Prefill logits through the kernel against the same prefill with the
    # plain attention on the card.
    toks = torch.from_numpy(prompts).to(dev)
    lg_k, _ = tl.prefill(params, tl.init_cache(cfg, N_REQUESTS, PROMPT_LEN,
                                               dev), toks, cfg)
    kernel_attend = tl.flash_attention
    tl.flash_attention = lambda q, k, v, causal, window: \
        fa.flash_attention_plain(q, k, v, causal=causal, window=window)[0]
    try:
        lg_p, _ = tl.prefill(params, tl.init_cache(
            cfg, N_REQUESTS, PROMPT_LEN, dev), toks, cfg)
    finally:
        tl.flash_attention = kernel_attend
    err = (lg_k - lg_p).abs().max().item()
    rel = err / lg_p.abs().max().item()
    same_argmax = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    logit_tol = 5e-2
    print(f"serving: prefill logits kernel vs plain attention max_abs_err="
          f"{err:.4e} max_rel_err={rel:.4e} (tol {logit_tol:g} relative to "
          f"the largest logit: bf16 activations re-rounded through "
          f"{layers} layers), greedy first token agrees on {same_argmax}/"
          f"{N_REQUESTS} rows", flush=True)
    ok = ok and rel <= logit_tol

    # Serving invariant: a row's tokens do not depend on its position.
    x = prompts.copy()
    x[5] = x[0]
    out = replica.forward(x)
    same = bool(np.array_equal(out[0], out[5]))
    print(f"serving: one prompt at rows 0 and 5 of bucket 8 gives identical "
          f"tokens: {same}", flush=True)
    ok = ok and same

    # Where the time goes: one prefill (time to first token) and one decode
    # step of the batch, then a profiled generate for the device's busy
    # share and its kernel time by name.
    cache = tl.init_cache(cfg, N_REQUESTS, PROMPT_LEN + NEW_TOKENS, dev)
    prefill_s = median_s(torch, lambda: tl.prefill(params, cache, toks, cfg))
    tok = lg_k.argmax(-1).to(torch.int32)
    decode_s = median_s(torch, lambda: tl.decode_step(params, cache, tok,
                                                      PROMPT_LEN, cfg))
    print(f"serving: prefill of the batch {prefill_s * 1e3:.3f} ms, one "
          f"decode step {decode_s * 1e3:.3f} ms (median of 5, host clock "
          f"around synchronised work)", flush=True)
    try:
        profile_generate(torch, lambda: tl.generate(params, toks,
                                                    NEW_TOKENS, cfg))
    except Exception as exc:  # noqa: BLE001 - a measurement, not a check
        print(f"profile: failed ({type(exc).__name__}: {exc}); busy share "
              f"not measured", flush=True)
    return ok, launches


def median_s(torch, fn, n=5):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2]


def profile_generate(torch, fn, top=8):
    """Kernel time by name and the device's busy share over one call,
    from torch.profiler's CUDA activity.  A measurement only: where the
    profiler records no device activity it says so and the run goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, busy = {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not by_name:
        print("profile: no device activity recorded; busy share not "
              "measured", flush=True)
        return
    print(f"profile: generate wall {wall * 1e3:.3f} ms (profiled), device "
          f"busy {busy / 1e3:.3f} ms = {busy / 1e6 / wall:.1%}, "
          f"{len(by_name)} kernel names", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile:   {us / 1e3:9.3f} ms  {name[:100]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth at llama3_8b width (default 32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import llama as tl
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    for name in libs:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{name}]: {line.strip()}", flush=True)

    dev = torch.device("cuda:0")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = flash_phase(torch, fa, dev, args.seed, flush)
    del flush
    serve_ok, launches = serving_phase(torch, hvd, tl, fa, args.layers,
                                       args.seed)

    main_case = cases[0]
    kernels_ok = all(c["ok"] for c in cases)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "horovod_tpu/ops/flash_attention.py:98",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "pass": kernels_ok and launches > 0,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    hvd.shutdown()
    if not (kernels_ok and serve_ok):
        _fail(f"kernels ok={kernels_ok}, serving ok={serve_ok}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
