#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--train-layers N] [--seed S]

Phases (any failure exits non-zero and prints no result line):

1. Card: the card's name and power limit, as nvidia-smi reports them.
   Then CUDA's module loading, in a child process a case alone on the
   card: lazy (torch's default) and eager (the launcher's) with the
   context's time and memory and a first GEMM's, and ``hvd.init()``'s
   request for eager loading made before the driver starts (it must hold)
   and after ``torch.cuda.is_available()`` (reported).
2. Build: every CUDA kernel of the port from its source, in parallel, and
   the copied coordinator beside them.
3. Kernels against their plain PyTorch versions on the card, with the
   stated tolerances, CUDA-event times of the kernel, the plain version
   and the one-call library yardstick (``library_ms``, never used by the
   port), and the bound computed from this run's shapes: the flash forward,
   then the flash backward's dq and dk/dv kernels (bitwise equal on a second
   call), each in five cases, at the training shape, at the ring's
   off-diagonal block (the training shape non-causal, what a ring step
   after the first runs), at Ulysses' inner attention (8,192 tokens
   causal, 16/4 heads) and at a tensor-parallel rank's shard (B=1, 4,096
   tokens causal, 16/4 heads), with TFLOP/s of the causally needed work;
   then
   34 bf16 cases at the edges of the tiles (128 rows; 64-row k tiles in
   dq) and with a window that ends mid-tile (correctness only).  Before
   them, ``cuobjdump -sass`` must find HGMMA (tensor-core) instructions in
   the bf16 forward, dq and dk/dv kernels.
4. Serving: ``init`` -> ``Replica.load`` -> ``ContinuousBatcher`` ->
   ``serve_loop`` at Llama-3-8B width (full depth by default), 8 requests
   of 512 prompt tokens, 16 greedy new tokens each; kernel launch counts
   are zeroed just before and read just after.  Then the prefill logits
   are recomputed with the plain attention and compared, and one prompt at
   two rows of one bucket must give identical tokens.  Last, the time of
   one prefill and one decode step, and a profiled ``generate`` for the
   card's busy share and kernel time by name.  Then E16 (a) on the same
   weights (``mistral_phase``; llama3_8b's shapes are mistral_7b's):
   ``to_hf_state_dict`` and ``from_hf_state_dict`` under ``mistral_7b()``
   bitwise; a prefill of 2 x 8,192 tokens (twice the window) through the
   windowed kernel against the plain windowed attention; 16 greedy tokens
   on the rolling cache against the full windowed cache; two
   ``speculative_generate`` runs (self, and the first 2 layers as the
   draft) against greedy up to near-ties.
5. Training: ``init`` -> ``init_params`` at Llama-3-8B width
   (``--train-layers`` deep, 4 by default) -> ``broadcast_parameters`` ->
   ``DistributedOptimizer(SGD)`` -> ``make_train_step``.  First the
   gradients of every leaf through the kernels against the same gradients
   with the plain attention under autograd (at a cut sequence length).  Then
   5 steps on one fixed batch of 2 x 4096 seeded tokens with the launch
   counts zeroed just before and read just after: the loss must be finite
   and fall, and each kernel must launch once per layer and step.  Last,
   the time per step, tokens/s, peak memory, and a profiled step.
6. The collective engine.  E1: the fusion pack and unpack kernels against
   their plain versions, bitwise: (A) the training configuration's 39 bf16
   gradients, (B) float32 with a bf16 wire and bf16 under factors, (C)
   int32 under Average, (D) an alignment sweep (odd numels, bases 1-7
   elements past an aligned one, an empty tensor between), (E) the byte
   path for bool, uint8, int8, int16, float64, complex64 and complex128
   and the float64, int8 and uint8 arithmetic, and 16-byte aligned bytes
   with a ragged end (the bulk copies); CUDA-event times on the gradient
   set (the card's time, with a sleep before the start event so that no
   wait for the host falls inside; the call's time, with any wait for the
   host inside; the host's time a call) with GB/s, the bound and the
   library yardstick, the bulk copies against the walk on the same bytes,
   and ``fusion.cu`` must build without spills.  E2: size 1 through the
   engine, a grouped allreduce of the gradient set and
   ``broadcast_parameters`` of the parameters and of a module with a
   buffer of each of those seven dtypes, bitwise against the plain path,
   with batches and launches = batches x dtype groups.  E3: two ranks,
   each a process of this script started by the port's launcher
   (``--e3-worker``), over NCCL — each rank on its own card where there
   are two, else both on one card over NCCL's socket transport: ``init``
   -> ``broadcast_parameters`` from rank 0 (the parameters, then the
   seven-dtype module) -> ``DistributedOptimizer(SGD)`` -> 5 steps at the
   training configuration's width cut to E3_LAYERS (as E4 and E5) on
   different batches per rank, with the
   parameters bitwise equal across ranks after every step, the
   negotiation counters, and pack and unpack launches = batches per step
   (the counts zeroed before the steps).  E1 case F: the kernels in the
   allgather layout (2 x 39 destination views) and the reducescatter and
   alltoall layout (2 x 39 source views, rank-major) on the gradient set,
   and the promoting casts (bool, int8, uint8, int16 -> int32 and back),
   bitwise, with times.  E3, E4 and E5 share one launch of two ranks
   through the port's launcher (``python -m horovod_tpu_torch.runner -np
   2 -H localhost:1,127.0.0.1:1``, ``-H localhost:2`` with two cards; one
   world formation for the three since PR 18).  E4, at
   the training configuration's width: reducescatter (Sum, Average) of
   the integer-valued bf16 gradient set and an allgather of the shards,
   bitwise against the sums each rank recomputes from both ranks' seeds;
   an even and a ragged alltoall of a [2 x 4096, 4096] bf16 activation;
   allgather_object and a join in which rank 1 submits one allreduce
   fewer (rank 0's result holds the fill value); SyncBatchNorm forward and
   backward on [32, 256, 56, 56] bf16 a rank against BatchNorm2d on the
   global batch; the promoting allreduce and reducescatter dtypes against
   the JAX engine's outcomes; each collective's time and its launches =
   dtype groups.
7. Sequence parallelism.  E5, in E3's launch after E4, the
   training configuration's width at the full max_seq of 8,192 tokens
   split over ``make_mesh({"sp": 2})`` (4,096 a rank), with
   ``DistributedOptimizer``'s hooks live: the averaged gradients at 4,096
   tokens against a single-rank full-sequence step (ring, then Ulysses),
   then E5_STEPS steps with ``sp_impl="ring"`` and E5_STEPS with
   ``"ulysses"`` from the
   broadcast weights: each rank loading its kernels eagerly, parameters
   bitwise equal across ranks every step, finite losses, the two engines'
   step-1 losses within 1e-3, the flash launches of the ring's schedule
   (rank r of n: forward layers x (r + 1), dq and dk/dv layers x (n - r) a
   step; Ulysses layers each), the step's time, the exchanges' time (CUDA
   events around each wait) and peak memory.
8. The model families (E6), at the full width of their published
   configurations.  The kernel phase above also runs the three attention
   shapes they give the kernels at head_dim 64 (BERT-Large B=8 T=512 16
   heads and ViT-B/16 B=32 T=197 12 heads, non-causal; GPT-2 B=8 T=1024
   12 heads, causal).  ResNet-50 (224², 1000 classes, width 64, batch 32,
   bf16 compute, float32 parameters and batch norm, channels_last) at
   size 1: steps of ``DistributedOptimizer(SGD momentum)`` on one fixed
   batch, the loss finite and lower at the end, images/s, the weight
   permute's cost and a profiled step.  BERT-Large (24 layers, T=512,
   B=8, a 15 % mask): the gradients through the kernels against the plain
   attention under autograd at T=256, then steps; ViT-B/16 and GPT-2
   (124M): steps, each with the flash launches (each kernel once a layer
   and step); GPT-2's greedy generation of 32 tokens, its cached logits
   against the flash forward's.  Then two ranks through the launcher as
   E3 (``--e6-worker``): ResNet-50 with the cross-rank batch norm, the
   MNIST convnet and BERT-Large with another mask count on each rank,
   each from rank 0's broadcast parameters: parameters (and ResNet's
   running statistics) bitwise equal across ranks every step, 2 x 53
   batch-norm exchanges a ResNet step, the allreduces and engine batches
   a step, pack = unpack launches = dtype groups.
9. Adasum and the two-level collectives.  The Adasum kernels against
   their plain versions (after the engine's E1): for each distinct size of
   the training configuration's gradients, the float32 halves of one (a
   first halving round's segments), then an odd length and an empty
   tensor; ``hvd_adasum_dots`` within DOTS_RTOL of a float64 sum and
   bitwise on a second call, ``hvd_adasum_combine`` bitwise its plain
   version (both sides, in place), with CUDA-event times, bounds and the
   library's calls.  Then E7 (``--e7-worker``, after E6): four ranks
   through the launcher with ``--hierarchical-allreduce
   --hierarchical-allgather --hierarchical-broadcast`` and
   ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2`` (two slices of two; one ``-H``
   entry a rank on one card, ``-H localhost:4`` with four cards): the
   two-level Sum/Average/Min/Max of an integer-valued bf16 decoder layer's
   gradients bitwise the flat submission and the exact result, two-level
   allgather and broadcast (the root in the other slice) bitwise flat,
   Adasum of a float32 gradient set two-level and flat (bitwise each other
   and across ranks, within ADASUM_RTOL/ATOL of the float64 tree), the
   tree on a process set of 3, then ``DistributedOptimizer(SGD,
   op=hvd.Adasum)`` training Llama at full width (E7_LAYERS deep) from
   rank 0's broadcast weights for E7_STEPS steps: parameters bitwise equal
   on the four ranks every step, the flash launches, and the Adasum launches =
   2 rounds x the steps' dtype groups.
10. Observability.  After E2, the trace A/B at size 1: the engine's
   grouped allreduce of the gradient set with the tracer detached and
   attached (off, on, on, off), no batch timed while detached.  Then E8
   (``--e8-worker``, after E7): two ranks through the launcher as E3 with
   ``--timeline-filename``, ``--timeline-mark-cycles``,
   ``--trace-filename``, ``--monitor``, ``--monitor-port`` (a free port)
   and ``--monitor-interval 1``, Llama at full width cut to E8_LAYERS,
   3 steps of
   ``DistributedOptimizer(SGD)`` with the launch counts zeroed before and
   read after: each rank's timeline parses with every gradient through
   QUEUE -> NEGOTIATE_ALLREDUCE -> NCCL_ALLREDUCE once a step and cycle
   marks; ``python -m horovod_tpu_torch.trace`` merges the two trace files
   (two rank lanes, cycle flows, a report naming the phases); rank 0's
   reduce phase above zero and its phase sum within 5 % of its mean
   lifecycle; each step's CUDA-event pack + NCCL + unpack time above zero
   and within the step; rank 0's /metrics, /health and /snapshot answering
   during step 2 with both ranks in the table; rank 0's
   ``hvd.profile_step`` trace of step 3 naming the pack's kernel and an
   NCCL kernel; pack = unpack launches = dtype groups; parameters bitwise
   equal across ranks every step; each rank's cross_rank, cross_size,
   is_homogeneous and capability probes.
11. ZeRO.  E9 (``--e9-worker``, after E8): two ranks through the launcher
   as E3 with ``--sharded``, ``HOROVOD_TRACE=1`` and
   ``HOROVOD_PIPELINE_CHUNK`` (E9_CHUNK: 6 buckets), Llama at full width
   cut to E9_LAYERS, B=2, T=4096, ``DistributedOptimizer(AdamW)`` for 3
   steps in three modes one after another in the same ranks, each from the
   same seeded parameters on the same token streams: replicated, ZeRO-1
   (``sharded=None``, from the flag) and FSDP (``sharded="full"``, its
   ``gather_params`` timed apart): the parameters' checksums equal across
   the modes and the ranks; ZeRO-1's optimizer state at most 0.55 of the
   replicated optimizer's; FSDP's ``memory_allocated`` between steps at
   most 0.55 of ZeRO-1's; ``prefetch_overlapped >= 1``; the FSDP saveable
   loaded bitwise into a new optimizer; for each mode the step's time
   after the first, the tracer's phases, the collectives' card time
   (``reduce_*_us_total``), peak memory and the launches.
12. Data-plane depth.  E10 (``--e10-worker``, after E9): two ranks through
   the launcher as E3 with ``--pipeline-chunk-mb 64
   --fast-lane-threshold-kb 64 --partition-threshold-mb 64`` and
   ``HOROVOD_TRACE=1``, the worker setting the engine's knobs between
   modes as the autotuner does.  (a) Llama at full width cut to
   E10_LAYERS, B=2, T=4096, SGD lr 0.75, 3 steps in each of three modes
   from the same seeded parameters and tokens: off; chunked at 64 MiB;
   partitioned at 64 MiB with the fast lane at 64 KB: the parameters'
   checksums equal across the modes and the ranks, more chunks than
   batches when chunked and pack launches = chunks, the partition splits
   the tensors above the threshold give, fast-lane batches and pin hits,
   ping-pong acquires, the flash launches, and each mode's step, NCCL,
   pack and unpack card ms, chunk overlap and memory.  (b) ResNet-50 at
   size 2 (E6's configuration), the fast lane off then on at 64 KB:
   parameters and statistics bitwise between the two, at least the 106
   batch-norm exchanges a step on the lane, pin hits from step 2, each
   step's ms and rank 0's kernels' busy share of its last step.  (d)
   during step 2 of (b)'s fast mode, 8 checkpoint-lane items writing a
   seeded payload: each run on the cycle thread with no gradient batch
   left in its cycle, at most the lane's budget a cycle, all dispatched,
   the files' bytes exact.  (c) a second launch (``--e10-tune-worker``)
   with ``--autotune``, warmup 1, 2 cycles a sample, 4 evaluations, over
   E10_TUNE_STEPS steps of that Llama at 1 layer: two samples or more, every applied
   move at the same lock-step round with the same knobs on both ranks, the
   search ended on both (its evaluations done, ``tuning`` off, one final
   line each in the log), the log parses, the parameters bitwise across
   the ranks every step.  E9's
   pack and unpack launches are held to its chunk plan (the replicated
   mode's allreduces chunk under ``HOROVOD_PIPELINE_CHUNK``).
13. Elastic training.  E11 (``--e11-worker``, after E10): the port's
   elastic launcher (``--host-discovery-script "cat <hosts>" --min-np 1
   --max-np 2 --ckpt-dir <tmp> --ckpt-chunk-mb 16``) over two loopback
   host entries sharing the card over NCCL's sockets; Llama at full width
   cut to E11_LAYERS, B=2, T=4096, replicated
   ``DistributedOptimizer(AdamW)`` under ``TorchState`` and
   ``@hvd.elastic.run``, committed after steps 1, 3, 5 and 7.  Generation
   1 (size 2) trains steps 1-3 and rank 1 kills itself in step 4's
   backward; generation 2 (size 1) is the survivor restored to step 3's
   commit, training steps 4-5, which then adds a third host entry to the
   host file; generation 3 (size 2) has the joiner restored from the
   survivor's shard server, steps 6-7, then a clean exit.  Nine checks
   (``e11_phase``) and the recovery, growth, commit, durable-write, peer
   restore and step times.
14. Drains, autoscaling and the two-level control plane.  E12
   (``--e12-driver``, after E10, side by side with E11 and then E13-E15:
   each in a thread of its own, its lines printed together at its end,
   the sweep held until all three have ended): ``run_elastic`` on
   ``--hierarchical-controller --autoscale --monitor-port <p>
   --preempt-grace-s 90 --commit-max-age-s 600 --scale-command ...`` over
   hosts ``127.0.0.1:2`` and ``127.0.0.2:1`` (three ranks on the card over
   NCCL's sockets, two behind host 0's agent), the script discovery given
   preemption notices from a file; Llama at full width cut to E12_LAYERS,
   B=2, T=4096, AdamW under ``TorchState`` and ``@hvd.elastic.run``
   (``--e12-worker``).  Generation 1 (size 3) trains steps 1-3, then a
   notice drains the second host (COMMIT, cordon, DRAIN, clean LEAVE);
   generation 2 (size 2) trains steps 4-5 from the live state; the host
   returns, generation 3 (size 3) restores a fresh worker there from a
   peer and trains steps 6-7, then idles until the policy scales the world
   in through rank 0's ``/health``; generation 4 (size 2) ends.  Eight
   checks (``e12_phase``) and the drain, ack, growth, scale-in and step
   times.
15. Expert parallelism.  E13 (after E11, beside E12): two ranks through the
   launcher as E3, on ``make_mesh({"ep": 2})``, the first part of the
   launch E13, E14 and E15 share (``--e14-worker``: one world formation
   for the three).  (a)
   ``mixtral_8x7b()`` at full width cut to E13_LAYERS (8 gated experts,
   top-2, capacity factor 4.0, bf16), B=1 x E13_SEQ tokens a rank, the
   replicated leaves through ``DistributedOptimizer(AdamW)``, the expert
   slabs through ``ExpertParallel(AdamW)``, E13_STEPS steps: every leaf's
   step-1 gradient against a reference with every expert local, the
   replicated leaves bitwise across the ranks and the slabs not, no token
   dropped, the flash launches, the all-to-all time.  (b) DLRM at MLPerf's
   widths (E13_DLRM; rows cut to 1 M a table), its tables split over ep,
   SGD, E13_STEPS steps of E13_DLRM_BATCH rows a rank, against an ep-off
   run of the global batch in this process: the losses and their change
   from step 1, the MLPs and every touched table row as values and as
   updates (after minus before).
16. Tensor parallelism.  E14 (``--e14-worker``, after E13 in its
   launch): on ``make_mesh({"tp": 2})``.  (a)
   ``llama3_8b()`` at full width cut to E14_LAYERS, bf16, B=1 x E14_SEQ
   tokens, the same on both ranks, the replicated leaves through
   ``DistributedOptimizer(AdamW)``, the tp shards (q heads, kv heads and
   hidden units by columns, ``wo``/``w2`` by rows) through
   ``ShardedParallel(AdamW)``, E14_STEPS steps: every leaf's step-1
   gradient against the matching block of the tp-off model's from the
   same weights and tokens, the replicated leaves bitwise across the ranks
   and the shards not, the losses bitwise across the ranks, the flash
   launches, the tp reductions' time and bytes and the replicated leaves'
   allreduce.  (b) Prefill of 2 x 512 tokens and 8 greedy tokens at tp =
   2 against the tp-off run on the same rank, fed its tokens: the logits
   within DECODE_TOL, 4 kv heads a rank in the cache, the generated tokens
   bitwise across the ranks.  (c) BERT-Large's width at E14_BERT_LAYERS,
   B=8, T=512, 8 heads a rank: one step's gradients against tp-off.
   Every time of two ranks on one card is labelled "sockets".
17. Pipeline parallelism.  E15, in E14's launch (one world formation
   fewer): the ranks shut E14's mesh down and make ``make_mesh({"pp":
   2})``.  (a) ``llama3_8b()`` cut to E15_LAYERS (one layer a stage),
   bf16, B=E15_BATCH x E15_SEQ tokens on both stages, E15_MICRO
   microbatches (mb = 1), ``pp_loss="broadcast"``, the slabs through
   ``ShardedParallel(AdamW)`` and the replicated leaves through
   ``DistributedOptimizer(AdamW)``, E15_STEPS steps: every leaf's step-1
   gradient against the matching slab of the pp-off model's from the same
   weights and tokens, the losses bitwise across the stages, the
   replicated leaves bitwise across the ranks and the slabs not, the flash
   launches (M x layers a stage of each kernel), the pp exchanges' count,
   bytes and time, the step, tokens/s and peak memory.  (b) One step at
   ``pp_loss="last_stage"`` with ``remat_stages`` from the same weights
   and tokens: its step-1 gradients against (a)'s, its peak above the
   step's start below (a)'s, the forward launches twice (a)'s.
18. Multi-process serving.  E16 (b) (``--e16-worker``, after E12 in its
   lane): two ranks under ``python -m horovod_tpu_torch.runner -np 2
   --serve --serve-port P``, ``mistral_7b()`` at full width cut to
   E16_LAYERS with the rolling cache: each rank's Config reads ``serve``
   and ``serve_port`` and its front door listens on P + rank; the v1
   fan-out from rank 0 (rank 1 from zeros, bitwise after; the repeat no
   broadcast); 8 HTTP requests of 512 tokens, 8 new each, to each rank's
   front door, the tokens bitwise across the ranks; a v2 update without a
   restart and its round; the drain (in flight 200, after it 503); the
   fan-out's GB/s and each front door's p50/p99.
19. The whole run's wall time, the kernels line (JSON), the card line, and
   the result line.

Every process the run starts carries ``CHIP_SMOKE_RUN`` in its
environment, and the run is their subreaper: after each launch of ranks
or drivers, before the result lines and at its exit (a failed one, and one
by SIGTERM, too) the run kills, reaps and names any of them, and any
descendant, still alive, and waits until the process table holds none of
them, so that none outlives it.  At RUN_LIMIT_S seconds the run fails and
ends so itself.

It imports nothing of JAX and nothing of ``horovod_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import math
import os
import re
import signal
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
TRAIN_BATCH = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 5
# E3-E5's depth at that width: two layers keep the script in its limit.
E3_LAYERS = 2
# Large enough that SGD updates of bf16 weights (their ulp is near 1e-4 at
# N(0, 1/4096)) do not round away.  Plain SGD on bf16 weights is not
# monotone at this size, so the check compares step 5 with step 1 only.
TRAIN_LR = 0.75
# The gradient check differentiates the plain attention under autograd,
# which keeps dense [B, H, T, T] float32 scores per layer: cut T for it.
# E16 (a): Mistral-7B on the serving phase's weights (llama3_8b's shapes
# are mistral_7b's): prompts of twice the 4,096-token window.
E16_BATCH = 2
E16_PROMPT = 8192
E16_NEW = 16
E16_DRAFT = 4            # n_draft of the speculative runs
E16_DRAFT_LAYERS = 2     # the shallow draft: the target's first layers
E16_TOL = 5e-2           # logits, relative to the largest (as in serving)
GRAD_CHECK_SEQ = 2048
GRAD_TOL = 5e-2
# The run ends itself, its processes stopped, at this many seconds after it
# began, before a harness's limit of 1,200 s would kill it and leave them.
RUN_LIMIT_S = 1175.0
_T0 = time.time()


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# Every process the run starts inherits this variable (its value names the
# run's own pid), whatever session or parent it ends under: stop_strays
# finds the ones still alive by it and by their descent from the run.
RUN_TAG = "CHIP_SMOKE_RUN"
# The pids alive when the run began: its exit names any other process still
# alive then that is not the run's own (it stops only its own).
_BEFORE_RUN = set()


def tag_run():
    """Marks this process as the run: the tag in its environment, which
    every process it starts inherits, and this process the subreaper of
    its descendants (``PR_SET_CHILD_SUBREAPER``), so that an orphan of a
    launcher or driver is reparented here and reaped here.  Registers
    ``_at_exit`` for the run's exit, a failed one too."""
    import atexit
    import ctypes
    os.environ[RUN_TAG] = f"{os.getpid()}.{time.time_ns()}"
    _BEFORE_RUN.update(_processes())
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:     # PR_SET_CHILD_SUBREAPER, on
        print(f"chip_smoke: not the subreaper of its processes (errno "
              f"{ctypes.get_errno()}); the tag alone finds them",
              file=sys.stderr, flush=True)
    atexit.register(_at_exit)
    # SIGTERM ends the run through its exit, which stops its processes.
    signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))
    threading.Thread(target=_run_limit, daemon=True).start()


def _run_limit():
    """At ``RUN_LIMIT_S`` the run fails: SIGTERM to itself, and if that has
    not ended it 10 s later, the processes stopped from here and an
    immediate exit."""
    time.sleep(max(0.0, _T0 + RUN_LIMIT_S - time.time()))
    print(f"FAIL: the run passed its limit of {RUN_LIMIT_S:g} s",
          flush=True)
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(10)
    stop_strays("limit", sys.stderr, force=True)
    os._exit(1)


def _processes():
    """``{pid: (ppid, state, tagged, command line)}`` of every live
    process, this one aside.  An exiting process's environment reads
    empty, so it shows untagged."""
    mark = f"{RUN_TAG}={os.environ[RUN_TAG]}".encode()
    table = {}
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as fh:
                tagged = mark in fh.read().split(b"\0")
        except OSError:
            tagged = False
        table[int(d)] = (int(fields[1]), fields[0], tagged, cmd)
    return table


def _strays():
    """``{pid: (state, command line)}`` of the run's processes still
    alive, this one aside: those that carry its tag and every descendant
    of this process or of them (an exiting one and a zombie too)."""
    table = _processes()
    children = {}
    for pid, (ppid, _, _, _) in table.items():
        children.setdefault(ppid, []).append(pid)
    ours = {pid for pid, (_, _, tagged, _) in table.items() if tagged}
    todo = [os.getpid(), *ours]
    while todo:
        for child in children.get(todo.pop(), ()):
            if child not in ours:
                ours.add(child)
                todo.append(child)
    return {pid: (table[pid][1], table[pid][3]) for pid in ours}


def _reap_children():
    """Reaps every child of this process that has exited (as subreaper,
    the run's orphans too)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


# Non-empty while phases run side by side: a phase's own sweep would stop
# the other's processes, so the sweep waits for all of them to end.
_SWEEPS_HELD = []


def stop_strays(where, out=None, timeout_s=30.0, force=False):
    """Kills (SIGKILL) every process of this run still alive when no phase
    is running, reaps them, and waits until none is left in the process
    table, naming each on ``out`` (stdout by default) under ``where``.
    Only the run's own process sweeps (a rank or a test calling a phase
    does not), and only ``force`` sweeps while phases run side by side.
    Returns the number found."""
    tag = os.environ.get(RUN_TAG, "")
    if tag.split(".")[0] != str(os.getpid()) or (_SWEEPS_HELD and not force):
        return 0
    out = out or sys.stdout
    _reap_children()
    found = {}
    left = _strays()
    t_end = time.time() + timeout_s
    while left and time.time() < t_end:
        found.update(left)
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        time.sleep(0.05)
        _reap_children()
        left = _strays()
    if found:
        print(f"{where}: stopped {len(found)} process(es) of this run still "
              f"alive after it: " + "; ".join(
                  f"pid {pid} state {st}: {cmd[:200]}"
                  for pid, (st, cmd) in sorted(found.items()))
              + (f"; still alive after {timeout_s:g} s: {sorted(left)}"
                 if left else ""), file=out, flush=True)
    return len(found)


def _at_exit():
    """The run's last act: stops its strays, then names on stderr any
    process begun during the run that is not its own and still alive."""
    stop_strays("exit", sys.stderr, force=True)
    if os.environ.get(RUN_TAG, "").split(".")[0] != str(os.getpid()):
        return
    others = {pid: v for pid, v in _processes().items()
              if pid not in _BEFORE_RUN}
    if others:
        print("exit: alive, begun during the run, not of it: " + "; ".join(
            f"pid {pid} ppid {ppid} state {st}: {cmd[:200]}"
            for pid, (ppid, st, _, cmd) in sorted(others.items())),
            file=sys.stderr, flush=True)


class _ThreadLines:
    """``sys.stdout`` while phases run side by side: what a phase's thread
    prints goes into that thread's own list, anything else to the real
    stream, so that each phase's lines are printed together at its end."""

    def __init__(self, real):
        self.real = real
        self.lines = {}

    def write(self, text):
        mine = self.lines.get(threading.get_ident())
        if mine is None:
            return self.real.write(text)
        mine.append(text)
        return len(text)

    def flush(self):
        if threading.get_ident() not in self.lines:
            self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


def side_by_side(where, lanes):
    """Runs ``lanes`` at once, a thread each: a lane runs its ``(name, fn,
    *args)`` phases one after the other, and stops at a phase that raised.
    The sweeps are held until every lane has ended; then each phase's lines
    are printed in the lanes' order, each with its own time, and the run
    sweeps.  Returns the phases' values by name; raises the first failed
    phase's exception."""
    out = _ThreadLines(sys.stdout)
    lines, res, errs, times = {}, {}, {}, {}

    def run(lane):
        for name, fn, *args in lane:
            out.lines[threading.get_ident()] = lines[name] = []
            t0 = time.time()
            try:
                res[name] = fn(*args)
            except BaseException as exc:    # noqa: B036 -- sys.exit too
                errs[name] = exc
            times[name] = time.time() - t0
            if name in errs:
                return

    threads = [threading.Thread(target=run, args=(lane,), daemon=True)
               for lane in lanes]
    t0 = time.time()
    _SWEEPS_HELD.append(where)
    sys.stdout = out
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.stdout = out.real
        _SWEEPS_HELD.remove(where)
        for lane in lanes:
            beside = ", ".join(name for other in lanes if other is not lane
                               for name, *_ in other)
            for name, *_ in lane:
                sys.stdout.write("".join(lines.get(name, [])))
                if name in times:
                    print(f"{name}: the phase in {times[name]:.1f} s "
                          f"(beside {beside})", flush=True)
        sys.stdout.flush()
    stop_strays(where)
    print(f"{where}: side by side in {time.time() - t0:.1f} s", flush=True)
    for lane in lanes:
        for name, *_ in lane:
            if name in errs:
                raise errs[name]
    return res


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=10, warmup=3, lead=False):
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, with the L2
    cache flushed before each (the serving path meets its inputs cold).
    ``lead``: the card sleeps about a millisecond before the start event,
    so the host has enqueued all of ``fn``'s work by then and the time is
    the card's alone, with no wait for the host inside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if lead:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# --------------------------------------------------------- module loading
# One child process a case, alone on the card: how it chooses the CUDA
# driver's module loading mode (argv[2]), then the context's creation and
# a first bf16 GEMM (cuBLAS's kernels), each timed, and the card's memory
# in use after each against before the child's context (nvidia-smi).
_LOADING_CHILD = r"""
import json, os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from horovod_tpu_torch.common import basics

def used_mib():
    return float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])

how = sys.argv[2]
base = used_mib()
if how == "init before the driver":
    basics._ask_eager_module_loading(2, None)
torch.cuda.is_available()
if how == "init after is_available":
    basics._ask_eager_module_loading(2, None)
t0 = time.perf_counter()
torch.cuda.set_device(0)
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
ctx_mib = used_mib() - base
x = torch.ones(256, 256, device="cuda", dtype=torch.bfloat16)
(x @ x).sum().item()
t2 = time.perf_counter()
print(json.dumps(dict(mode=basics.cuda_module_loading(), ctx_s=t1 - t0,
                      ctx_mib=ctx_mib, gemm_s=t2 - t1,
                      gemm_mib=used_mib() - base)))
"""
# (case, CUDA_MODULE_LOADING in the child's env, the mode it must get;
# None: reported, not held)
_LOADING_CASES = (
    ("torch's default", "LAZY", "LAZY"),
    ("the launcher's", "EAGER", "EAGER"),
    ("init before the driver", None, "EAGER"),
    ("init after is_available", None, None),
)


def module_loading_phase():
    """What eager module loading (the launcher's, and ``hvd.init()``'s
    request at a size above 1) costs a rank against CUDA's lazy default:
    the context's time and device memory, then a first GEMM's.  Runs
    before this process makes a context, so each child is alone on the
    card."""
    here = os.path.dirname(os.path.abspath(__file__))
    ok = True
    for name, env_mode, want in _LOADING_CASES:
        env = {k: v for k, v in os.environ.items()
               if k != "CUDA_MODULE_LOADING"}
        if env_mode:
            env["CUDA_MODULE_LOADING"] = env_mode
        res = subprocess.run([sys.executable, "-c", _LOADING_CHILD, here,
                              name], env=env, capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            print(f"loading[{name}]: child failed: {res.stderr[-2000:]}",
                  flush=True)
            ok = False
            continue
        m = json.loads(res.stdout.strip().splitlines()[-1])
        good = want is None or m["mode"] == want
        ok = ok and good
        print(f"loading[{name}]: CUDA_MODULE_LOADING={env_mode} -> driver "
              f"mode {m['mode']} (want {want or 'any'}); context "
              f"{m['ctx_s'] * 1e3:.1f} ms, {m['ctx_mib']:.0f} MiB; first "
              f"bf16 GEMM {m['gemm_s'] * 1e3:.1f} ms, then "
              f"{m['gemm_mib']:.0f} MiB in use (nvidia-smi, against before "
              f"the context) -> {'PASS' if good else 'FAIL'}", flush=True)
    return ok


# ------------------------------------------------------------- flash cases
# (name, B, Tq, Tk, H, K, D, dtype, causal, window, o-tolerance, reason)
_BF16_REASON = ("bf16 output rounding (2^-8 relative) plus p rounded to "
                "bf16 at a different running max in the kernel's online "
                "softmax than in the dense plain version")
_F32_REASON = ("same float32 arithmetic; sums taken in another order and "
               "exp/log from other implementations")
TRAIN_CASE = "training shape: B=2 T=4096 causal GQA rep 4, bf16"
RING_CASE = "ring off-diagonal block: B=2 T=4096 non-causal GQA rep 4, bf16"
ULYSSES_CASE = ("Ulysses inner attention: B=2 T=8192 causal, 16/4 heads, "
                "bf16")
TP_CASE = "tensor-parallel shard: B=1 T=4096 causal, 16/4 heads, bf16"
MISTRAL_CASE = ("Mistral windowed prefill: B=1, T=8192, 32/8 heads, D=128, "
                "causal, window 4096, bf16")
# Forward-only cases: a prefill's shape, which no backward runs.
FWD_ONLY_CASES = (MISTRAL_CASE,)
# E6: the models' attention at head_dim 64.
BERT_CASE = "BERT-Large attention: B=8 T=512 16 heads D=64 non-causal, bf16"
VIT_CASE = "ViT-B/16 attention: B=32 T=197 12 heads D=64 non-causal, bf16"
GPT2_CASE = "GPT-2 attention: B=8 T=1024 12 heads D=64 causal, bf16"
MODEL_CASES = {"bert": BERT_CASE, "vit": VIT_CASE, "gpt2": GPT2_CASE}
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
    (TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 128, "bfloat16",
     True, None, 2e-2, _BF16_REASON),
    # What a ring step s > 0 runs (E5): a whole 4,096-token block of k/v
    # for 4,096 queries, non-causal.
    (RING_CASE, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 128, "bfloat16",
     False, None, 2e-2, _BF16_REASON),
    # What Ulysses runs inside its all-to-alls (E5): the whole 8,192-token
    # sequence, causal, with this rank's half of the heads.
    (ULYSSES_CASE, TRAIN_BATCH, 2 * TRAIN_SEQ, 2 * TRAIN_SEQ, 16, 4, 128,
     "bfloat16", True, None, 2e-2, _BF16_REASON),
    # What a tp rank of E14 runs: half of Llama-3-8B's heads, causal.
    (TP_CASE, 1, TRAIN_SEQ, TRAIN_SEQ, 16, 4, 128, "bfloat16", True, None,
     2e-2, _BF16_REASON),
    # What E16's Mistral prefill runs a layer and prompt: twice the window,
    # the tiles below the band skipped.
    (MISTRAL_CASE, 1, 2 * TRAIN_SEQ, 2 * TRAIN_SEQ, 32, 8, 128, "bfloat16",
     True, 4096, 2e-2, _BF16_REASON),
    # What E6's models run: q, k, v [B, T, heads, 64] of each layer.
    (BERT_CASE, 8, 512, 512, 16, 16, 64, "bfloat16", False, None, 2e-2,
     _BF16_REASON),
    (VIT_CASE, 32, 197, 197, 12, 12, 64, "bfloat16", False, None, 2e-2,
     _BF16_REASON),
    (GPT2_CASE, 8, 1024, 1024, 12, 12, 64, "bfloat16", True, None, 2e-2,
     _BF16_REASON),
]
# The numbers of one case that the kernels line carries under a prefix.
_CASE_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "max_abs_err", "tflops")
LSE_TOL = 1e-4   # float32 on both sides: only summation order differs
_BWD_BF16_REASON = ("ds rounded to bf16 from f32 sums taken in another "
                    "order (an element near a rounding boundary rounds the "
                    "other way), bf16 outputs")


def _bound(nbytes, ops, dt_name):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dt_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _sdpa(F, q, k, v, causal, window, mask):
    """The library yardstick: one scaled_dot_product_attention call on the
    same [B, T, heads, D] inputs (never used by the port)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


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
        bound_ms, bound_by = _bound(nbytes, ops, dt_name)
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, window=window), flush)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), flush)
        library_ms = time_ms(torch, _sdpa(F, q, k, v, causal, window, mask),
                             flush)
        print(f"flash[{name}] B={B} Tq={Tq} Tk={Tk} H={H} K={K} D={D} "
              f"{dt_name} causal={causal} window={window}: "
              f"o max_abs_err={err_o:.3e} max_rel_err={rel_o:.3e} "
              f"(tol {tol:g} abs: {reason}); lse max_abs_err={err_l:.3e} "
              f"max_rel_err={rel_l:.3e} (tol {LSE_TOL:g} abs: {_F32_REASON})"
              f"; empty rows {int(empty.sum())}; kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.1f} MB"
              f", {ops / 1e9:.2f} GFLOP) -> {'PASS' if ok else 'FAIL'}",
              flush=True)
        results.append(dict(case=name, ok=ok, max_abs_err=err_o, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            tflops=ops / ms / 1e9))
        del q, k, v, o, lse, o_p, lse_p
    return results


def flash_bwd_phase(torch, fa, dev, seed, flush):
    """The dq and dk/dv kernels against the plain backward, in the cases of
    the forward but the forward-only ones (a prefill's), with a random do,
    the forward kernel's own lse and delta from o."""
    import torch.nn.functional as F
    results = []
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    for (name, B, Tq, Tk, H, K, D, dt_name, causal, window, _,
         _) in FLASH_CASES:
        if name in FWD_ONLY_CASES:
            continue
        dt = getattr(torch, dt_name)
        tol, reason = ((2e-2, _BWD_BF16_REASON) if dt == torch.bfloat16
                       else (1e-4, _F32_REASON))
        q, k, v, do = (torch.randn(B, T, h, D, generator=gen, device=dev)
                       .to(dt) for T, h in ((Tq, H), (Tk, K), (Tk, K),
                                            (Tq, H)))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        scale = 1.0 / D ** 0.5
        out = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
        torch.cuda.synchronize()
        again = fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                       causal=causal, window=window)
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        del again
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                           causal=causal, window=window)
        errs = {}
        for g, a, b in zip(("dq", "dk", "dv"), out, ref):
            err = (a.float() - b.float()).abs().max().item()
            errs[g] = (err, err / max(b.float().abs().max().item(), 1e-30))
        ok = bitwise and all(rel <= tol for _, rel in errs.values())
        del out, ref
        mask = fa._mask(Tq, Tk, causal, window, dev)
        pairs = int(mask.sum().item())
        io = sum(x.numel() * x.element_size() for x in (q, k, v, do)) \
            + 2 * lse.numel() * 4
        dq_ops, dkv_ops = 6.0 * D * pairs * B * H, 8.0 * D * pairs * B * H
        dq_bound = _bound(io + q.numel() * q.element_size(), dq_ops, dt_name)
        dkv_bound = _bound(io + 2 * k.numel() * k.element_size(), dkv_ops,
                           dt_name)
        ops = fa._bwd_operands(q, k, v, do, lse, delta)
        dq_ms = time_ms(torch, lambda: fa._launch_dq(
            *ops, causal, scale, window), flush)
        dkv_ms = time_ms(torch, lambda: fa._launch_dkv(
            *ops, causal, scale, window), flush)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, delta, causal=causal, window=window), flush,
            iters=5, warmup=1)
        qkv = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o_lib = _sdpa(F, *qkv, causal, window, mask)()
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, qkv, do.transpose(1, 2), retain_graph=True), flush)
        print(f"flash_bwd[{name}] B={B} Tq={Tq} Tk={Tk} H={H} K={K} D={D} "
              f"{dt_name} causal={causal} window={window}: "
              + "; ".join(f"{g} max_abs_err={e:.3e} max_rel_err={r:.3e}"
                          for g, (e, r) in errs.items())
              + f" (tol {tol:g} relative to the largest reference value: "
              f"{reason}); second call bitwise equal: {bitwise}; dq kernel "
              f"{dq_ms:.4f} ms ({dq_ops / dq_ms / 1e9:.1f} TFLOP/s, bound "
              f"{dq_bound[0] * 1e3:.2f} us by {dq_bound[1]}), dk/dv kernel "
              f"{dkv_ms:.4f} ms ({dkv_ops / dkv_ms / 1e9:.1f} TFLOP/s, bound "
              f"{dkv_bound[0] * 1e3:.2f} us by {dkv_bound[1]}), plain "
              f"backward {plain_ms:.4f} ms, library (SDPA backward) "
              f"{library_ms:.4f} ms, {dq_ops / 1e9:.2f} + "
              f"{dkv_ops / 1e9:.2f} GFLOP -> "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        results.append(dict(
            case=name, ok=ok, plain_ms=plain_ms, library_ms=library_ms,
            dq=dict(max_abs_err=errs["dq"][0], ms=dq_ms,
                    bound_ms=dq_bound[0], bound_by=dq_bound[1],
                    tflops=dq_ops / dq_ms / 1e9),
            dkv=dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                     ms=dkv_ms, bound_ms=dkv_bound[0],
                     bound_by=dkv_bound[1], tflops=dkv_ops / dkv_ms / 1e9)))
        del q, k, v, do, o, lse, delta, ops, qkv, o_lib
        torch.cuda.empty_cache()
    return results


# The edges of the bfloat16 kernels' tiles (128 rows; the dq kernel's k
# tiles are 64): Tq = Tk one past a 64-row tile, one short of, one past and
# one past two 128-row tiles, causal and not, D 64 and 128, GQA rep 1 and 8
# (one kv head); then a causal window of 100, a multiple of neither tile
# size, so that rows' first keys and blocks' first live k tiles fall
# mid-tile.  Correctness only: at these sizes a time is noise.
EDGE_CASES = [(T, causal, D, rep, None) for T in (65, 127, 129, 257)
              for causal in (True, False) for D in (64, 128)
              for rep in (1, 8)] + [(257, True, D, 8, 100) for D in (64, 128)]


def edge_phase(torch, fa, dev, seed):
    """Forward and backward kernels against the plain versions at the tile
    edges, bf16, at the tolerances of the main cases."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    ok_all = True
    for T, causal, D, rep, window in EDGE_CASES:
        q, k, v, do = (torch.randn(1, T, h, D, generator=gen, device=dev)
                       .bfloat16() for h in (rep, 1, 1, rep))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
        err_o = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        out = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
        again = fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                       causal=causal, window=window)
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                           causal=causal, window=window)
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        rel = {g: (a.float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30)
               for g, a, b in zip(("dq", "dk", "dv"), out, ref)}
        ok = (err_o <= 2e-2 and err_l <= LSE_TOL and bitwise
              and all(r <= 2e-2 for r in rel.values()))
        ok_all = ok_all and ok
        print(f"edge[T={T} causal={causal} window={window} D={D} "
              f"rep={rep}] bf16: o "
              f"max_abs_err={err_o:.3e}, lse {err_l:.3e}, "
              + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
              + f" (tol 2e-2 / {LSE_TOL:g} / 2e-2 relative), bitwise "
              f"{bitwise} -> {'PASS' if ok else 'FAIL'}", flush=True)
    return ok_all


# The kernels that must run on the tensor cores, by library, each at both
# head dims.
TENSOR_CORE_KERNELS = {
    "flash_fwd": ["flash_fwd_wgmma_kernel"],
    "flash_bwd": ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"]}
HEAD_DIMS = (64, 128)


def tensor_core_check(_build, libs):
    """Every bf16 forward, dq and dk/dv kernel in the built libraries, at
    D = 64 and 128, holds HGMMA (wgmma) instructions, by ``cuobjdump
    -sass``."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    ok = True
    for lib, wants in TENSOR_CORE_KERNELS.items():
        try:
            res = subprocess.run([tool, "-sass", libs[lib]],
                                 capture_output=True, text=True, timeout=300)
        except OSError as exc:
            print(f"sass[{lib}]: cuobjdump failed ({exc})", flush=True)
            ok = False
            continue
        funcs = res.stdout.split("Function : ")[1:]
        for want in wants:
            found = {}
            for f in funcs:
                name = f.split()[0]
                # The mangled template argument: ...kernelILi128EE...
                m = re.search(want + r"ILi(\d+)E", name)
                if m:
                    found[int(m.group(1))] = f.count("HGMMA")
            for d, n in sorted(found.items()):
                print(f"sass[{lib}]: {want}<{d}> has {n} HGMMA "
                      f"instructions", flush=True)
            good = res.returncode == 0 and all(
                found.get(d, 0) > 0 for d in HEAD_DIMS)
            print(f"sass[{lib}]: {want} on the tensor cores at D in "
                  f"{HEAD_DIMS}: {good}", flush=True)
            ok = ok and good
    return ok


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
        profile_call(torch, "generate", lambda: tl.generate(
            params, toks, NEW_TOKENS, cfg))
    except Exception as exc:  # noqa: BLE001 - a measurement, not a check
        print(f"profile: failed ({type(exc).__name__}: {exc}); busy share "
              f"not measured", flush=True)
    # E16 (a) takes these weights over: nothing else may hold them.
    replica.params = None
    del replica, cache, lg_k, lg_p, tok, out
    torch.cuda.empty_cache()
    e16 = mistral_phase(torch, tl, fa, params, layers, seed)
    return ok, launches, e16


def _plain_attention(torch, fa, q, k, v, causal, window):
    """The plain windowed attention a batch row and a kv head's q heads at
    a time (the plain version computes each head alone, so this is its
    function; its float32 scores stay one head group's)."""
    g = q.shape[2] // k.shape[2]
    return torch.cat([torch.cat([fa.flash_attention_plain(
        q[b:b + 1, :, j * g:(j + 1) * g], k[b:b + 1, :, j:j + 1],
        v[b:b + 1, :, j:j + 1], causal=causal, window=window)[0]
        for j in range(k.shape[2])], dim=2) for b in range(q.shape[0])])


def _hf_pairs(params):
    """``(Hugging Face name, leaf, transposed)`` for every leaf of a dense
    Llama tree, in the orientation ``to_hf_state_dict`` writes."""
    pairs = [("model.embed_tokens.weight", params["embed"], False),
             ("model.norm.weight", params["final_norm"], False),
             ("lm_head.weight", params["lm_head"], True)]
    for i, lay in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        pairs += [(pre + "input_layernorm.weight", lay["attn_norm"], False),
                  (pre + "post_attention_layernorm.weight", lay["mlp_norm"],
                   False)]
        pairs += [(f"{pre}{n}.weight", lay[key], True) for n, key in (
            ("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
            ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
            ("mlp.gate_proj", "w1"), ("mlp.up_proj", "w3"),
            ("mlp.down_proj", "w2"))]
    return pairs


def _margins(torch, logits):
    """The greedy token's lead over the runner-up, per row."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).tolist()


def mistral_phase(torch, tl, fa, params, layers, seed):
    """E16 (a), in the serving phase's process on its weights (llama3_8b's
    shapes are mistral_7b's; ``params`` is emptied here).  (1) The weights
    out through ``to_hf_state_dict`` and back through
    ``from_hf_state_dict`` under ``mistral_7b()``, each original freed once
    its export is checked: every leaf bitwise.  (2) A prefill of
    E16_BATCH x E16_PROMPT seeded tokens (twice the window) through the
    windowed flash forward, then with the plain windowed attention: the
    last logits within E16_TOL of the largest, ``layers`` launches.  (3)
    E16_NEW greedy tokens on the rolling cache, each step's token fed to the
    full windowed cache too: every step's logits within E16_TOL, the tokens
    that agree, each decode step's time in both modes.  (4)
    ``speculative_generate`` with n_draft = E16_DRAFT on the rolling target,
    self-speculation and a draft of its first E16_DRAFT_LAYERS layers: ε,
    the largest gap between ``decode_chunk``'s and ``decode_step``'s
    logits at the same positions, and the tokens equal to greedy's at every
    position before the first whose top-two margin is below 2ε; rounds,
    accepted tokens a round, wall time against ``generate``'s.  Returns
    (ok, the flash launches)."""
    import numpy as np
    from horovod_tpu_torch.models import convert
    dev = params["embed"].device
    cfg = tl.mistral_7b(n_layers=layers)
    roll = tl.mistral_7b(n_layers=layers, rolling_cache=True)
    ok, launches = True, 0
    t_phase = time.time()

    # (1) export, import.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = convert.to_hf_state_dict(params, cfg)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    export_equal = all(torch.equal(sd[n].t() if tr else sd[n], t)
                       for n, t, tr in _hf_pairs(params))
    params.clear()          # the originals: only the export holds them now
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new = convert.from_hf_state_dict(sd, cfg)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    import_equal = all(torch.equal(sd[n].t() if tr else sd[n], t)
                       for n, t, tr in _hf_pairs(new))
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    del sd
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = new
    print(f"e16: to_hf_state_dict {export_s:.3f} s, from_hf_state_dict "
          f"under mistral_7b() {import_s:.3f} s ({nbytes / 1e9:.2f} GB, "
          f"on the card), every exported tensor bitwise the original's: "
          f"{export_equal}, every imported leaf bitwise the export's: "
          f"{import_equal}, peak {peak:.2f} GiB allocated", flush=True)
    ok = ok and export_equal and import_equal

    # (2) the windowed prefill, kernel against plain.
    prompts = torch.from_numpy(np.random.RandomState(seed + 16).randint(
        0, cfg.vocab_size, (E16_BATCH, E16_PROMPT)).astype(np.int64)).to(dev)
    slots = E16_PROMPT + E16_NEW
    full_cache = tl.init_cache(cfg, E16_BATCH, slots, dev)
    _zero_flash(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_k, _ = tl.prefill(params, full_cache, prompts, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_launches = fa.flash_attention_fwd.launches
    kernel_attend = tl.flash_attention
    tl.flash_attention = lambda q, k, v, causal, window: _plain_attention(
        torch, fa, q, k, v, causal, window)
    try:
        t0 = time.perf_counter()
        lg_p, _ = tl.prefill(params, tl.init_cache(cfg, E16_BATCH, E16_PROMPT,
                                                   dev), prompts, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tl.flash_attention = kernel_attend
    rel = (lg_k - lg_p).abs().max().item() / lg_p.abs().max().item()
    same = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    good = rel <= E16_TOL and pre_launches == layers
    print(f"e16: prefill B={E16_BATCH} x T0={E16_PROMPT} (window "
          f"{cfg.sliding_window}) through the kernel {prefill_ms:.1f} ms, "
          f"flash launches {pre_launches} (want {layers}); with the plain "
          f"windowed attention {plain_ms:.1f} ms; last logits "
          f"max_rel_err={rel:.4e} (tol {E16_TOL:g} relative to the largest "
          f"logit), first token agrees on {same}/{E16_BATCH} rows -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    ok = ok and good
    launches += pre_launches
    del lg_p
    torch.cuda.empty_cache()

    # (3) rolling against full: the rolling loop's greedy tokens fed to
    # both caches.
    ring = tl.init_cache(roll, E16_BATCH, device=dev)
    _zero_flash(fa)
    lg_r, _ = tl.prefill(params, ring, prompts, roll)
    torch.cuda.synchronize()
    roll_launches = fa.flash_attention_fwd.launches
    launches += roll_launches
    ring_after_prefill = [{k: v.clone() for k, v in c.items()} for c in ring]
    ring_gb = sum(t.numel() * t.element_size() for c in ring
                  for t in c.values()) / 1e9
    full_gb = sum(t.numel() * t.element_size() for c in full_cache
                  for t in c.values()) / 1e9
    errs = [(lg_r - lg_k).abs().max().item() / lg_k.abs().max().item()]
    step_logits, margins = [lg_r], [_margins(torch, lg_r)]
    tok = lg_r.argmax(-1).to(torch.int32)
    toks_r, toks_f = [tok], [lg_k.argmax(-1).to(torch.int32)]
    ms = {"rolling": [], "full": []}
    for pos in range(E16_PROMPT, E16_PROMPT + E16_NEW - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr, _ = tl.decode_step(params, ring, tok, pos, roll)
        torch.cuda.synchronize()
        ms["rolling"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        lf, _ = tl.decode_step(params, full_cache, tok, pos, cfg)
        torch.cuda.synchronize()
        ms["full"].append((time.perf_counter() - t0) * 1e3)
        errs.append((lr - lf).abs().max().item() / lf.abs().max().item())
        step_logits.append(lr)
        margins.append(_margins(torch, lr))
        toks_f.append(lf.argmax(-1).to(torch.int32))
        tok = lr.argmax(-1).to(torch.int32)
        toks_r.append(tok)
    greedy = torch.stack(toks_r, dim=1)
    agree = int((greedy == torch.stack(toks_f, dim=1)).sum())
    good = max(errs) <= E16_TOL and tuple(ring[0]["k"].shape) == (
        E16_BATCH, cfg.sliding_window + roll.rolling_slack, cfg.n_kv_heads,
        cfg.head_dim) and roll_launches == layers
    print(f"e16: {E16_NEW} greedy tokens on the rolling cache (ring "
          f"{list(ring[0]['k'].shape)} a layer, {ring_gb:.2f} GB in all) "
          f"against the full windowed cache ({list(full_cache[0]['k'].shape)}"
          f", {full_gb:.2f} GB): worst step logits max_rel_err="
          f"{max(errs):.4e} (tol {E16_TOL:g}), tokens agreeing "
          f"{agree}/{greedy.numel()}; decode step median rolling "
          f"{float(np.median(ms['rolling'])):.3f} ms, full "
          f"{float(np.median(ms['full'])):.3f} ms (host clock around "
          f"synchronised work); flash launches of the rolling prefill "
          f"{roll_launches} -> {'PASS' if good else 'FAIL'}", flush=True)
    ok = ok and good
    del full_cache, lg_k
    torch.cuda.empty_cache()

    # (4) speculative decoding.  ε: decode_chunk against decode_step at
    # the same positions, from the ring as the prefill left it.
    chunk = greedy[:, :E16_DRAFT + 1]
    lc, _ = tl.decode_chunk(params, ring_after_prefill, chunk, E16_PROMPT,
                            roll)
    eps = max((lc[:, i] - step_logits[i + 1]).abs().max().item()
              for i in range(E16_DRAFT + 1))
    del ring_after_prefill, ring, lc
    torch.cuda.empty_cache()
    _zero_flash(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tl.generate(params, prompts, E16_NEW, roll)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches += fa.flash_attention_fwd.launches
    m = np.asarray(margins).T                   # [B, E16_NEW]
    drafts = (("self", params, roll),
              (f"first {E16_DRAFT_LAYERS} layers",
               {**params, "layers": params["layers"][:E16_DRAFT_LAYERS]},
               tl.mistral_7b(n_layers=E16_DRAFT_LAYERS, rolling_cache=True)))
    for name, dparams, dcfg in drafts:
        tl.speculative_generate.rounds = tl.speculative_generate.accepted = 0
        _zero_flash(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec = tl.speculative_generate(params, dparams, prompts, E16_NEW,
                                       roll, draft_cfg=dcfg,
                                       n_draft=E16_DRAFT)
        torch.cuda.synchronize()
        spec_s = time.perf_counter() - t0
        launches += fa.flash_attention_fwd.launches
        rounds = tl.speculative_generate.rounds
        accepted = tl.speculative_generate.accepted
        equal = (spec == greedy).cpu().numpy()
        held, first_tie = True, []
        for b in range(E16_BATCH):
            tie = np.nonzero(m[b] < 2 * eps)[0]
            upto = int(tie[0]) if len(tie) else E16_NEW
            first_tie.append(upto)
            held = held and bool(equal[b, :upto].all())
        print(f"e16: speculative_generate, draft {name}, n_draft "
              f"{E16_DRAFT}: {rounds} rounds, {accepted / max(rounds, 1):.2f}"
              f" draft tokens accepted a round, {spec_s:.3f} s against "
              f"generate's {gen_s:.3f} s; tokens equal to greedy "
              f"{int(equal.sum())}/{equal.size}, every one before the first "
              f"near-tie (top-two margin < 2 eps, eps={eps:.4e} the largest "
              f"gap of decode_chunk's logits to decode_step's; first at "
              f"{first_tie}): {held}; flash launches "
              f"{fa.flash_attention_fwd.launches} -> "
              f"{'PASS' if held else 'FAIL'}", flush=True)
        ok = ok and held
    del drafts, dparams, params, new
    torch.cuda.empty_cache()
    print(f"e16: (a) in {time.time() - t_phase:.1f} s, flash launches "
          f"{launches}", flush=True)
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


def profile_call(torch, label, fn, top=8):
    """Kernel time by name (the ``top`` largest, then every flash kernel of
    the port below them) and the device's busy share over one call, from
    torch.profiler's CUDA activity.  A measurement only: where the profiler
    records no device activity it says so and the run goes on."""
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
    print(f"profile: {label} wall {wall * 1e3:.3f} ms (profiled), device "
          f"busy {busy / 1e3:.3f} ms = {busy / 1e6 / wall:.1%}, "
          f"{len(by_name)} kernel names", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in ranked[:top] + [kv for kv in ranked[top:]
                                    if "flash_" in kv[0]]:
        print(f"profile:   {us / 1e3:9.3f} ms  {name[:100]}", flush=True)


# ---------------------------------------------------------------- training
def _leaf_grads(tl, params, x, y, cfg):
    for _, t in tl.named_parameters(params):
        t.grad = None
    loss = tl.loss_fn(params, x, y, cfg)
    loss.backward()
    grads = {n: t.grad.detach().clone() for n, t in
             tl.named_parameters(params)}
    for _, t in tl.named_parameters(params):
        t.grad = None
    return loss.item(), grads


def training_phase(torch, hvd, tl, fa, layers, seed):
    import numpy as np
    hvd.init()
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=layers)
    print(f"training: llama3_8b width, depth cut to {layers} of 32 layers, "
          f"B={TRAIN_BATCH} T={TRAIN_SEQ}, SGD lr {TRAIN_LR}", flush=True)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 1))
    hvd.broadcast_parameters(params, root_rank=0)
    named = list(tl.named_parameters(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
        named_parameters=named)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = tl.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    n_params = sum(t.numel() for _, t in named)
    print(f"training: {n_params / 1e9:.3f} B params bf16 in {len(named)} "
          f"leaves on {dev}", flush=True)

    # Gradients through the kernels against the plain attention under
    # autograd, at the initial parameters, on the first GRAD_CHECK_SEQ
    # tokens of each row (also the warm-up).
    xc, yc = x[:, :GRAD_CHECK_SEQ], y[:, :GRAD_CHECK_SEQ]
    loss_k, g_k = _leaf_grads(tl, params, xc, yc, cfg)
    kernel_attend = tl.flash_attention
    tl.flash_attention = lambda q, k, v, causal, window: \
        fa.flash_attention_plain(q, k, v, causal=causal, window=window)[0]
    try:
        loss_p, g_p = _leaf_grads(tl, params, xc, yc, cfg)
    finally:
        tl.flash_attention = kernel_attend
    worst, ok = (0.0, ""), True
    for n in g_k:
        a, b = g_k[n].float(), g_p[n].float()
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        ok = ok and rel <= GRAD_TOL and bool(torch.isfinite(a).all())
        worst = max(worst, (rel, n))
        print(f"training: grad[{n}] kernel vs plain attention max_rel_err="
              f"{rel:.3e} cosine={cos:.6f}", flush=True)
    print(f"training: gradient check at T={GRAD_CHECK_SEQ} (cut from "
          f"{TRAIN_SEQ}: the plain attention under autograd keeps dense "
          f"scores), {len(g_k)} leaves, loss kernel {loss_k:.6f} plain "
          f"{loss_p:.6f}, worst max_rel_err {worst[0]:.3e} at {worst[1]} "
          f"(tol {GRAD_TOL:g} relative to the leaf's largest reference "
          f"gradient: bf16 activations re-rounded through {layers} layers "
          f"and ds rounded to bf16 in the kernels) -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    del g_k, g_p
    torch.cuda.empty_cache()

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(params, x, y).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash_fwd": fa.flash_attention_fwd.launches,
                "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv}
    want = layers * TRAIN_STEPS
    step_s = sorted(times)[len(times) // 2]
    print(f"training: losses {[round(v, 6) for v in losses]}, step times "
          f"{[round(t * 1e3, 3) for t in times]} ms, median "
          f"{step_s * 1e3:.3f} ms = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{launches} (= {layers} layers x {TRAIN_STEPS} steps = {want} "
          f"each expected), card {torch.cuda.get_device_name(0)}",
          flush=True)
    falls = all(np.isfinite(losses)) and losses[-1] < losses[0]
    print(f"training: loss finite and lower at step {TRAIN_STEPS} than at "
          f"step 1: {falls}", flush=True)
    ok = ok and falls and all(n == want for n in launches.values())
    try:
        profile_call(torch, "train step", lambda: step(params, x, y))
    except Exception as exc:  # noqa: BLE001 - a measurement, not a check
        print(f"profile: failed ({type(exc).__name__}: {exc}); busy share "
              f"not measured", flush=True)
    return ok, launches


# ------------------------------------------------------------- the engine
def _grad_shapes(torch, tl, layers, dev, seed):
    """The training configuration's parameter leaves, by name and shape."""
    cfg = tl.llama3_8b(n_layers=layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed))
    shapes = [(n, tuple(t.shape)) for n, t in tl.named_parameters(params)]
    del params
    torch.cuda.empty_cache()
    return shapes


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _err(a, b):
    """The largest absolute difference of two tensors of one dtype."""
    if a.numel() == 0:
        return 0.0
    if a.dtype.is_complex:
        return (a - b).abs().max().item()
    return (a.double() - b.double()).abs().max().item()


def _views(fill, numels):
    """Tensors of ``numels`` elements from ``fill(n)``, each a view whose
    base lies 1-7 elements past an aligned one."""
    return [fill(1 + k % 7 + n)[1 + k % 7:] for k, n in enumerate(numels)]


def _fusion_cases(torch, grads, dev, gen):
    """E1's cases: (name, tensors, buffer dtype, outputs or None, pre,
    post, divisor)."""
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def randn(dt):
        return lambda n: torch.randn(n, generator=gen, device=dev).to(dt)

    def randint(dt, lo, hi):
        return lambda n: torch.randint(lo, hi, (n,), generator=gen,
                                       device=dev, dtype=dt)

    mixed = ([torch.randn(s, generator=gen, device=dev)
              for s in ((4096, 4096), (1024, 4096), (4096,))]
             + [torch.randn(s, generator=gen, device=dev).to(bf16)
                for s in ((4096, 14336), (4096,))])
    ints = [torch.randint(-1001, 1002, s, generator=gen, device=dev,
                          dtype=i32) for s in ((3000, 7), (1,))]
    cases = [("A: training gradient set, bf16, Average over 2", grads, bf16,
              None, None, None, 2),
             ("B: float32, bf16 wire, pre 0.5, post 1/3, Average over 2",
              mixed[:3], bf16, None, 0.5, 1 / 3, 2),
             ("B: bf16, pre 0.5, post 1/3, Average over 2", mixed[3:], bf16,
              None, 0.5, 1 / 3, 2),
             ("C: int32, negative odd sums, Average over 2", ints, i32, None,
              None, None, 2)]
    # D: the alignment sweep.  Every base (inputs and outputs) 1-7
    # elements past an aligned one, an empty tensor in the middle.
    numels = (1, 7, 8, 9, 0, 4095, 4097)
    for label, fill, wire in (("bf16", randn(bf16), bf16),
                              ("float32 -> bf16 wire", randn(f32), bf16),
                              ("int32", randint(i32, -1001, 1002), i32)):
        for how, pre, post, div in (("bytes", None, None, 1),
                                    ("pre 0.5, post 1/3, Average over 2",
                                     0.5, 1 / 3, 2)):
            ts = _views(fill, numels)
            outs = _views(fill, numels)
            cases.append((f"D: {label}, shifted bases, {how}", ts, wire,
                          outs, pre, post, div))
    # E: the byte path for every dtype the arithmetic path does not take,
    # and the float64, int8 and uint8 arithmetic.
    shapes = ((333, 7), (0,), (1,), (4097,))
    byte_fills = {
        torch.bool: lambda n: torch.randint(0, 2, (n,), generator=gen,
                                            device=dev).bool(),
        torch.uint8: randint(torch.uint8, 0, 256),
        torch.int8: randint(torch.int8, -128, 128),
        torch.int16: randint(torch.int16, -32768, 32768),
        torch.float64: lambda n: torch.randn(n, generator=gen, device=dev,
                                             dtype=torch.float64),
        torch.complex64: lambda n: torch.randn(
            n, generator=gen, device=dev, dtype=torch.complex64),
        torch.complex128: lambda n: torch.randn(
            n, generator=gen, device=dev, dtype=torch.complex128)}
    for dt, fill in byte_fills.items():
        ts = [fill(math.prod(s)).view(s) for s in shapes[:-1]]
        ts += _views(fill, [shapes[-1][0]])
        cases.append((f"E: {str(dt)[6:]}, bytes", ts, dt, None, None, None,
                      1))
    # The bulk copies: 16-byte aligned tensors, the last one ragged, 48 MB
    # (several chunks a block, so every stage of the ring is reused).
    ts = [byte_fills[torch.uint8](n) for n in (16 * 4096, 0, 16 * 1000,
                                               48 * 10**6 + 7)]
    cases.append(("E: uint8, bytes, 16-byte aligned, the last tensor "
                  "ragged (bulk copies)", ts, torch.uint8, None, None, None,
                  1))
    for dt, pre, post in ((torch.float64, 0.5, 1 / 3), (torch.int8, 0.5, None),
                          (torch.uint8, None, None)):
        ts = [byte_fills[dt](math.prod(s)).view(s) for s in shapes]
        cases.append((f"E: {str(dt)[6:]}, Average over 2"
                      + (f", pre {pre}" if pre else "")
                      + (", post 1/3" if post else ""), ts, dt, None, pre,
                      post, 2))
    return cases


def _host_us(torch, fn, iters=20):
    """The host's time to issue one call of ``fn``, while the card sleeps
    (so no call waits for the card)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / iters * 1e6


def _copy_kernel(torch, fusion, tensors, raw, to_buffer, aligned):
    """A function that launches ``hvd_fusion_copy`` alone between
    ``tensors`` and the bytes ``raw``, its table built now: by the bulk
    copies (``aligned`` 1; every tensor 16-byte aligned) or by the walk
    (0).  A comparison only: the wrappers build a table each call, take
    the bulk copies whenever they can, and count their launches."""
    offs = fusion._offsets([t.numel() * t.element_size() for t in tensors])
    table = fusion._table([t.data_ptr() for t in tensors], offs, raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    lib = fusion._lib()

    def launch():
        err = lib.hvd_fusion_copy(table.data_ptr(), len(tensors), offs[-1],
                                  raw.data_ptr(), int(to_buffer), aligned,
                                  stream)
        if err:
            raise RuntimeError(f"hvd_fusion_copy failed: CUDA error {err}")
    return launch


def fusion_phase(torch, fusion, grads, dev, seed, flush):
    """E1: the pack and unpack kernels against their plain versions, on
    (A) the 39 bf16 gradients of the training configuration as the
    two-rank Average moves them (no factors, divisor 2: the byte path in,
    the arithmetic path out), (B) float32 with a bf16 wire and bf16, with
    prescale 0.5, postscale 1/3 and divisor 2, (C) int32 with negative odd
    sums under Average, (D) an alignment sweep (numels 1, 7, 8, 9, 0, 4095,
    4097 at bases 1-7 elements past an aligned one, inputs and outputs, in
    bf16, float32 -> bf16 wire and int32, by bytes and with arithmetic),
    (E) the byte path for bool, uint8, int8, int16, float64, complex64 and
    complex128, and the float64, int8 and uint8 arithmetic under Average
    over 2.  Every case must be bitwise equal to the plain version: the
    kernels round where it rounds (fusion.cu).  Times for (A): CUDA events,
    L2 flushed."""
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    bf16 = torch.bfloat16
    ok, err_pack, err_unpack = True, 0.0, 0.0
    for name, ts, wire, outs, pre, post, divisor in _fusion_cases(
            torch, grads, dev, gen):
        buf = fusion.pack(ts, wire, pre)
        outs = outs if outs is not None else [torch.empty_like(t)
                                              for t in ts]
        fusion.unpack(buf, outs, divisor, post)
        torch.cuda.synchronize()
        ref_buf = fusion.pack_plain(ts, wire, pre)
        ref_outs = [torch.empty_like(t) for t in ts]
        fusion.unpack_plain(ref_buf, ref_outs, divisor, post)
        e_p = _err(buf, ref_buf)
        e_u = max(_err(o, r) for o, r in zip(outs, ref_outs))
        same = torch.equal(buf, ref_buf) and all(
            torch.equal(o, r) for o, r in zip(outs, ref_outs))
        ok = ok and same
        err_pack, err_unpack = max(err_pack, e_p), max(err_unpack, e_u)
        print(f"fusion[{name}] {len(ts)} x {ts[0].dtype} -> {wire}: pack "
              f"max_abs_err={e_p:.3e}, unpack max_abs_err={e_u:.3e}, "
              f"bitwise equal to the plain version: {same} -> "
              f"{'PASS' if same else 'FAIL'}", flush=True)
        del buf, outs, ref_buf, ref_outs
    # Times at the training gradient set (case A): the card's time (a lead
    # before the start event, so no wait for the host is inside it) of the
    # kernel, its plain version and the library call; the call's time (the
    # host's work for the call inside the events when the card waits for
    # it); and the host's time a call.
    buf = fusion.pack(grads, bf16)
    outs = [torch.empty_like(g) for g in grads]
    sizes = [g.numel() for g in grads]
    in_b, buf_b = _nbytes(grads), buf.numel() * buf.element_size()
    res = {}
    for kern, nbytes, fn, plain, lib in (
            ("pack", in_b + buf_b, lambda: fusion.pack(grads, bf16),
             lambda: fusion.pack_plain(grads, bf16, None),
             lambda: torch.cat([g.reshape(-1) for g in grads])),
            ("unpack", buf_b + in_b, lambda: fusion.unpack(buf, outs, 2),
             lambda: fusion.unpack_plain(buf, outs, 2, None),
             lambda: (torch._foreach_copy_(outs, [
                 s.view(o.shape) for s, o in zip(buf.split(sizes), outs)]),
                 torch._foreach_mul_(outs, 0.5)))):
        ms = time_ms(torch, fn, flush, lead=True)
        call_ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, iters=5, warmup=1, lead=True)
        library_ms = time_ms(torch, lib, flush, iters=5, warmup=1, lead=True)
        host = {w: _host_us(torch, f) for w, f in (("kernel", fn),
                                                    ("library", lib))}
        bound_ms, bound_by = _bound(nbytes, 0, "bfloat16")
        lib_name = ("torch.cat" if kern == "pack" else
                    "split + _foreach_copy_ + _foreach_mul_")
        print(f"fusion[{kern}] training gradient set, {len(grads)} bf16 "
              f"tensors, {nbytes / 1e9:.3f} GB moved: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"library ({lib_name}) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by}; the call with the host's "
              f"work inside the events {call_ms:.4f} ms; host time a call: "
              f"kernel {host['kernel']:.1f} us, library "
              f"{host['library']:.1f} us", flush=True)
        res[kern] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, gbps=nbytes / ms / 1e6,
                         host_us=host["kernel"],
                         max_abs_err=err_pack if kern == "pack"
                         else err_unpack)
    print(f"fusion: pack no slower than torch.cat on the card: "
          f"{res['pack']['ms'] <= res['pack']['library_ms']}", flush=True)
    # The other paths at the same size, the card's time: unpack by bytes (a
    # broadcast group: the bulk copies), pack with every tensor at another
    # 16-byte phase than its place in the buffer (one bf16 element first:
    # the walk, realigning), the byte copies' kernel alone on a table built
    # before, by the bulk copies and by the walk, and a one-tensor copy_.
    one = torch.zeros(1, dtype=bf16, device=dev)
    shifted = [one] + grads
    raw = buf.view(torch.uint8)
    dst = torch.empty_like(raw)
    for what, fn in (("unpack by bytes (divisor 1), bulk copies",
                      lambda: fusion.unpack(buf, outs)),
                     ("pack, sources at another 16-byte phase, walk",
                      lambda: fusion.pack(shifted, bf16)),
                     ("pack by bytes, bulk copies, kernel alone",
                      _copy_kernel(torch, fusion, grads, raw, True, 1)),
                     ("pack by bytes, walk, kernel alone",
                      _copy_kernel(torch, fusion, grads, raw, True, 0)),
                     ("unpack by bytes, bulk copies, kernel alone",
                      _copy_kernel(torch, fusion, outs, raw, False, 1)),
                     ("unpack by bytes, walk, kernel alone",
                      _copy_kernel(torch, fusion, outs, raw, False, 0)),
                     ("one-tensor copy_ of the same bytes (the card's own "
                      "device-to-device copy)", lambda: dst.copy_(raw))):
        ms = time_ms(torch, fn, flush, lead=True)
        nbytes = in_b + buf_b
        print(f"fusion[{what}] training gradient set: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s), bound "
              f"{_bound(nbytes, 0, 'bfloat16')[0]:.4f} ms", flush=True)
        res[what] = ms
    del buf, outs, dst
    return ok, res


def layout_phase(torch, fusion, grads, dev, seed, flush):
    """E1 case F: the fusion kernels in the new collectives' layouts at a
    world of two, on the training gradient set, and on the promoting
    casts; each bitwise equal to its plain version.  (F1) The allgather
    unpack: two ranks' buffers (here the same bytes twice) through 2 x 39
    destination views into outputs of twice the rows.  (F2) The
    reducescatter and alltoall pack: 2 x 39 source views, rank-major.
    (F3) The reducescatter unpack: rank 0's chunk under Average over 2
    into 39 outputs of half the rows.  (F4) The widening pack (bool, int8,
    uint8, int16 -> int32) and, after the buffer is doubled as a sum of
    two equal ranks, the narrowing unpack (int32 -> int16 past int16's
    range, floor-divided by 2; bool's int32 counts divided by 2; int32
    read as uint32), and an int32 buffer into float32 under a division
    (a reducescatter's Average of integers).  Times: the card's, as E1's
    case A."""
    from horovod_tpu_torch.ops import engine
    world, bf16, i32 = 2, torch.bfloat16, torch.int32
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    numels = [g.numel() for g in grads]
    sizes = engine._rows(grads, world)
    ok, res = True, {}

    def verdict(name, got, ref, extra=""):
        nonlocal ok
        # uint32 compares as its int32 bits (its CUDA operators are few).
        got, ref = ([t.view(i32) if t.dtype == torch.uint32 else t
                     for t in ts] for ts in (got, ref))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, ref))
        err = max(_err(a, b) for a, b in zip(got, ref))
        ok = ok and same
        print(f"fusion[F: {name}]: max_abs_err={err:.3e}, bitwise equal to "
              f"the plain version: {same}{extra} -> "
              f"{'PASS' if same else 'FAIL'}", flush=True)
        return err

    def timed(name, fn, plain, lib, lib_name, nbytes):
        ms = time_ms(torch, fn, flush, lead=True)
        plain_ms = time_ms(torch, plain, flush, iters=3, warmup=1, lead=True)
        lib_ms = time_ms(torch, lib, flush, iters=3, warmup=1, lead=True)
        bound_ms = _bound(nbytes, 0, "bfloat16")[0]
        print(f"fusion[F: {name}] training gradient set, {nbytes / 1e9:.3f}"
              f" GB moved: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)"
              f", plain {plain_ms:.4f} ms, library ({lib_name}) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes",
              flush=True)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, gbps=nbytes / ms / 1e6)

    # F1: the allgather unpack.
    buf = fusion.pack(grads, bf16)
    gathered = torch.cat([buf, buf])
    outs = [torch.empty((world * g.shape[0],) + tuple(g.shape[1:]),
                        dtype=bf16, device=dev) for g in grads]
    dst = engine._views(outs, numels, world)
    fusion.unpack(gathered, dst)
    torch.cuda.synchronize()
    ref = [torch.empty_like(o) for o in outs]
    fusion.unpack_plain(gathered, engine._views(ref, numels, world), 1, None)
    verdict("allgather unpack, 2 x 39 destination views", outs, ref,
            f"; each output is its gradient twice: "
            f"{all(torch.equal(o, torch.cat([g, g])) for o, g in zip(outs, grads))}")
    del ref
    parts = [v.numel() for v in dst]
    timed("allgather unpack", lambda: fusion.unpack(gathered, dst),
          lambda: fusion.unpack_plain(gathered, dst, 1, None),
          lambda: torch._foreach_copy_(dst, list(gathered.split(parts))),
          "split + _foreach_copy_", 2 * gathered.numel() * 2)
    del gathered, outs, dst
    # F2: the rank-major pack of the reducescatter and the alltoall.
    src = engine._views(grads, sizes, world)
    packed = fusion.pack(src, bf16)
    torch.cuda.synchronize()
    verdict("reducescatter/alltoall pack, 2 x 39 source views, rank-major",
            [packed], [fusion.pack_plain(src, bf16, None)])
    timed("rank-major pack", lambda: fusion.pack(src, bf16),
          lambda: fusion.pack_plain(src, bf16, None),
          lambda: torch.cat([v.reshape(-1) for v in src]), "torch.cat",
          2 * packed.numel() * 2)
    # F3: the reducescatter unpack of rank 0's chunk, Average over 2.
    chunk = packed[:sum(sizes)]
    halves = [torch.empty((g.shape[0] // world,) + tuple(g.shape[1:]),
                          dtype=bf16, device=dev) for g in grads]
    fusion.unpack(chunk, halves, 2)
    torch.cuda.synchronize()
    ref = [torch.empty_like(h) for h in halves]
    fusion.unpack_plain(chunk, ref, 2, None)
    verdict("reducescatter unpack, Average over 2, 39 half outputs", halves,
            ref)
    del ref
    timed("reducescatter unpack", lambda: fusion.unpack(chunk, halves, 2),
          lambda: fusion.unpack_plain(chunk, halves, 2, None),
          lambda: (torch._foreach_copy_(halves, [
              p.view(h.shape) for p, h in zip(chunk.split(
                  [h.numel() for h in halves]), halves)]),
              torch._foreach_mul_(halves, 0.5)),
          "split + _foreach_copy_ + _foreach_mul_", 2 * chunk.numel() * 2)
    del buf, packed, chunk, halves, src
    torch.cuda.empty_cache()
    # F4: the promoting casts.
    shapes = ((333, 7), (0,), (1,), (4097,))

    def ints(dt, lo, hi):
        return [torch.randint(lo, hi, s, generator=gen, device=dev,
                              dtype=dt) for s in shapes]
    cases = (("bool -> int32, counts / 2 (bool Average)",
              [t.bool() for t in ints(torch.uint8, 0, 2)], i32, 2),
             ("int8 -> int32 (int8 Product)", ints(torch.int8, -128, 128),
              i32, 1),
             ("uint8 -> int32 -> uint32 (uint8 Product)",
              ints(torch.uint8, 0, 256), torch.uint32, 1),
             ("int16 -> int32 -> int16 past its range, floor / 2 (int16 "
              "Average)", ints(torch.int16, -32768, 32768), torch.int16, 2),
             ("int32 -> float32, / 2 (reducescatter Average of int32)",
              ints(i32, -70000, 70000), torch.float32, 2),
             ("int16 -> int32 -> int16 past its range -> float32, / 2 "
              "(reducescatter Average of int16)",
              ints(torch.int16, -32768, 32768), torch.float32, 2))
    for name, ts, out_dt, divisor in cases:
        narrow = torch.int16 if ts[0].dtype == torch.int16 \
            and out_dt == torch.float32 else None
        b = fusion.pack(ts, i32)
        ref_b = fusion.pack_plain(ts, i32, None)
        red = b * 2
        red = red.view(torch.uint32) if out_dt == torch.uint32 else red
        outs = [torch.empty(t.shape, dtype=out_dt, device=dev) for t in ts]
        fusion.unpack(red, outs, divisor, narrow=narrow)
        torch.cuda.synchronize()
        ref_red = ref_b * 2
        ref_red = ref_red.view(torch.uint32) if out_dt == torch.uint32 \
            else ref_red
        ref = [torch.empty_like(o) for o in outs]
        fusion.unpack_plain(ref_red, ref, divisor, None, narrow)
        verdict(name, [b] + outs, [ref_b] + ref)
    return ok, res


def _expected_batches(nbytes, threshold):
    """The engine's cut of one cycle's ungrouped entries of one fusion key:
    a new batch where the next tensor would pass the threshold."""
    batches, cur = 0, 0
    for b in nbytes:
        if cur and cur + b > threshold:
            batches, cur = batches + 1, 0
        cur += b
    return batches + (1 if cur else 0)


# The dtypes that only the byte path carries, or whose arithmetic is new.
BYTE_DTYPES = ("bool", "uint8", "int8", "int16", "float64", "complex64",
               "complex128")


def _dtype_module(torch, dev, seed):
    """A module with a float32 parameter and a registered buffer of each of
    ``BYTE_DTYPES``, from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mod = torch.nn.Module()
    mod.weight = torch.nn.Parameter(torch.randn(32, 64, generator=gen,
                                                device=dev))
    for k, name in enumerate(BYTE_DTYPES):
        dt = getattr(torch, name)
        shape = (97 + k, 3)
        if dt.is_floating_point or dt.is_complex:
            t = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, shape, generator=gen, device=dev).bool()
        else:
            info = torch.iinfo(dt)
            t = torch.randint(info.min, info.max + 1, shape, generator=gen,
                              device=dev, dtype=dt)
        mod.register_buffer(f"buf_{name}", t)
    return mod


def _byte_sums(torch, tensors):
    """A position-weighted sum of each tensor's bytes."""
    sums = []
    for t in tensors:
        v = t.detach().reshape(-1).view(torch.uint8).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 251 + 1
        sums.append(int((v * w).sum()))
    return sums


def engine_size1_phase(torch, hvd, tl, fusion, grads, layers, seed):
    """E2: the engine at size 1 on the card (local negotiation, fusion,
    pack, unpack; the collective is the identity): a grouped allreduce of
    the gradient set (one atomic group: one batch), broadcast_parameters
    of the training configuration's parameters (cut at the fusion
    threshold) and of a module with a buffer of each of ``BYTE_DTYPES``
    (bool and uint8 among them: one batch, a dtype group each, by bytes),
    each bitwise equal to its input, which
    is what the plain path gives at size 1; launches = batches x dtype
    groups."""
    hvd.init()
    dev = hvd.device()
    eng = hvd.common.basics._get_state().engine
    cfg = tl.llama3_8b(n_layers=layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 3))
    named = list(tl.named_parameters(params))
    before = [t.detach().clone() for _, t in named]
    mod = _dtype_module(torch, dev, seed + 4)
    mod_before = [t.clone() for t in mod.state_dict().values()]
    n_batches = _expected_batches([t.numel() * t.element_size()
                                   for _, t in named], eng.fusion_threshold)
    ok = True
    for what, run, expect, inputs, outputs in (
            ("grouped_allreduce of the gradient set",
             lambda: hvd.grouped_allreduce(grads), (1, 1), grads, None),
            ("broadcast_parameters of the parameters",
             lambda: hvd.broadcast_parameters(params), (n_batches, n_batches),
             before, [t for _, t in named]),
            ("broadcast_parameters of a module with a buffer of each of "
             + ", ".join(BYTE_DTYPES),
             lambda: hvd.broadcast_parameters(mod),
             (1, 1 + len(BYTE_DTYPES)), mod_before,
             list(mod.state_dict().values()))):
        d0, g0 = eng.pipeline_dispatches, eng.fused_groups
        fusion.pack.launches = fusion.unpack.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = (fusion.pack.launches, fusion.unpack.launches)
        batches, groups = eng.pipeline_dispatches - d0, eng.fused_groups - g0
        outs = out if outputs is None else outputs
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(outs, inputs))
        good = (same and (batches, groups) == expect
                and launches == (groups, groups))
        ok = ok and good
        print(f"engine[size 1: {what}]: {len(inputs)} tensors "
              f"({sorted({str(t.dtype)[6:] for t in inputs})}), bitwise "
              f"equal to the plain path: {same}, batches {batches}, dtype "
              f"groups {groups} (expected {expect}), pack/unpack launches "
              f"{launches} (= dtype groups) -> {'PASS' if good else 'FAIL'}",
              flush=True)
        del out, outs
    del params, named, before, mod, mod_before
    torch.cuda.empty_cache()
    return ok


def _checksum(torch, named):
    """Two integer sums over every tensor's bits (bf16 read as int16,
    float32 as int32): equal on two ranks only if the tensors are, but for
    a collision."""
    s1 = s2 = 0
    for _, t in named:
        iv = torch.int32 if t.element_size() == 4 else torch.int16
        v = t.detach().reshape(-1).view(iv).to(torch.int64)
        s1 += int(v.sum())
        s2 += int((v * v).sum())
        del v
    return [s1, s2]


def _e3_rank(args):
    """E3 on this rank (the first part of ``e3_worker``): broadcast_parameters
    from rank 0 (rank 1 starts from other seeds) -> DistributedOptimizer(SGD)
    -> 5 steps on this rank's own batch; its counters and checks."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    r, dev = hvd.rank(), hvd.device()
    eng = hvd.common.basics._get_state().engine
    ctl = eng.controller
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1 + 1000 * r))
    named = list(tl.named_parameters(params))
    sums_before = _checksum(torch, named)
    t0 = time.perf_counter()
    hvd.broadcast_parameters(params, root_rank=0)
    torch.cuda.synchronize()
    bcast_s = time.perf_counter() - t0
    sums_bcast = _checksum(torch, named)
    # Every dtype the byte path carries, over NCCL: rank 1's buffers start
    # from another seed and must end as rank 0's bytes.
    mod = _dtype_module(torch, dev, args.seed + 4 + r)
    mod_before = _byte_sums(torch, mod.state_dict().values())
    hvd.broadcast_parameters(mod, root_rank=0)
    mod_bcast = _byte_sums(torch, mod.state_dict().values())
    del mod
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
        named_parameters=named)
    step = tl.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0
    fusion.pack.launches = fusion.unpack.launches = 0
    steps = []
    for _ in range(TRAIN_STEPS):
        st = ctl.cache_stats
        c0 = (ctl.rounds, ctl.bytes_sent, st.hits, st.misses,
              st.full_announces, eng.pipeline_dispatches, eng.fused_groups,
              fusion.pack.launches, fusion.unpack.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, x, y).item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c1 = (ctl.rounds, ctl.bytes_sent, st.hits, st.misses,
              st.full_announces, eng.pipeline_dispatches, eng.fused_groups,
              fusion.pack.launches, fusion.unpack.launches)
        d = [b - a for a, b in zip(c0, c1)]
        steps.append(dict(
            loss=loss, s=dt, rounds=d[0], bytes=d[1], hits=d[2],
            misses=d[3], full_announces=d[4], batches=d[5],
            dtype_groups=d[6], pack=d[7], unpack=d[8],
            slots=len(ctl._slots), sums=_checksum(torch, named)))
    res = dict(rank=r, device=str(dev), card=torch.cuda.get_device_name(dev),
               leaves=len(named), bcast_s=bcast_s, sums_before=sums_before,
               sums_bcast=sums_bcast, mod_before=mod_before,
               mod_bcast=mod_bcast, steps=steps,
               pack=fusion.pack.launches, unpack=fusion.unpack.launches,
               flash=[fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches_dq,
                      fa.flash_attention_bwd.launches_dkv])
    return res


def _write_result(directory, res):
    """A rank's result, at the path its launcher rank names."""
    path = os.path.join(directory, f"rank{os.environ['HOROVOD_RANK']}.json")
    with open(path, "w") as fh:
        json.dump(res, fh)


def launch_ranks(torch, flag, layers, seed, timeout_s, np_=2,
                 launcher_flags=(), env_extra=None, inspect=None):
    """``np_`` copies of this script with ``flag``, started by the port's
    launcher: ``python -m horovod_tpu_torch.runner -np N -H
    localhost:1,127.0.0.1:1,...`` on one card, one ``-H`` entry a rank (the
    launcher gives each host entry its own NCCL_HOSTID, and the loopback
    entries NCCL's socket transport on ``lo``: NCCL refuses two ranks of
    one host on one GPU), ``-H localhost:N`` with N cards or more (each
    rank on ``cuda:{local rank}``).  ``launcher_flags`` go to the launcher
    (``{tmp}`` in one is the ranks' result directory), ``env_extra`` into
    its environment (which the workers inherit).  ``inspect(tmp)``, when
    given, runs after the ranks succeeded and before the directory goes,
    and its value is appended to the results.  Returns ``(results, route,
    wall)``, results None when a rank failed; every process is gone on
    return."""
    import signal
    import tempfile
    tag = flag[2:].split("-")[0]        # "e3" of "--e3-worker"
    ndev = torch.cuda.device_count()
    if ndev >= np_:
        hosts = f"localhost:{np_}"
        route = "NCCL, one card per rank"
    else:
        hosts = ",".join(["localhost:1"] + [f"127.0.0.{i}:1"
                                            for i in range(1, np_)])
        route = (f"NCCL socket transport on loopback, all {np_} ranks on "
                 f"one card (NCCL_HOSTID per -H entry)")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), **(env_extra or {}))
    with tempfile.TemporaryDirectory() as tmp:
        logs = os.path.join(tmp, "logs")
        flags = [f.format(tmp=tmp) for f in launcher_flags]
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
               str(np_), "-H", hosts, *flags, "--output-filename",
               logs, sys.executable, os.path.abspath(__file__),
               "--train-layers", str(layers), "--seed", str(seed), flag, tmp]
        shown = [f"{k}={v}" for k, v in (env_extra or {}).items()]
        shown += ["python"] + cmd[1:cmd.index("--output-filename") + 2]
        print(f"{tag}: {' '.join(shown)} python chip_smoke.py {flag} {tmp}",
              flush=True)
        t0 = time.time()
        launcher = subprocess.Popen(cmd, cwd=here, env=env,
                                    start_new_session=True)
        try:
            rc = launcher.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if launcher.poll() is None:
                os.killpg(launcher.pid, signal.SIGKILL)
                launcher.wait()
        wall = time.time() - t0
        stop_strays(tag)
        results = []
        for r in range(np_):
            path = os.path.join(tmp, f"rank{r}.json")
            if rc != 0 or not os.path.exists(path):
                tail = ""
                for f in (os.path.join(logs, f"rank.{r}", "stdout"),
                          os.path.join(logs, f"rank.{r}", "stderr"),
                          os.path.join(tmp, f"stacks{r}.txt")):
                    if os.path.exists(f):
                        with open(f) as fh:
                            tail += fh.read()[-6000:]
                print(f"{tag}: rank {r} failed (launcher rc {rc}, "
                      f"route {route}); the end of its output:\n{tail}",
                      flush=True)
                results = None
            elif results is not None:
                with open(path) as fh:
                    results.append(json.load(fh))
        if results is not None and inspect is not None:
            results.append(inspect(tmp))
    return results, route, wall


# The JAX engine's allreduce outcomes on two ranks for the dtypes NCCL does
# not reduce as it does (ROADMAP queue 3; tests/test_torch_dtypes.py holds
# the port to the same on the CPU): dtype, the two ranks' values, and per
# op the result's dtype and values, or "raises".
PROMOTE_CASES = (
    ("bool", ([True, False, True], [True, True, False]),
     {"Sum": ("int32", [2, 1, 1]), "Average": ("int32", [1, 0, 0]),
      "Product": ("int32", [1, 0, 0]), "Min": ("bool", [True, False, False]),
      "Max": ("bool", [True, True, True])}),
    ("int16", ([30000, -2, 300], [30000, 5, -7]),
     {"Sum": ("int16", [-5536, 3, 293]), "Average": ("int16", [-2768, 1, 146]),
      "Product": ("int32", [900000000, -10, -2100]),
      "Min": ("int16", [30000, -2, -7]), "Max": ("int16", [30000, 5, 300])}),
    ("int8", ([100, 3, -7], [3, 90, 2]),
     {"Sum": ("int8", [103, 93, -5]), "Product": ("int32", [300, 270, -14])}),
    ("uint8", ([100, 3, 7], [3, 90, 2]),
     {"Product": ("uint32", [300, 270, 14])}),
    ("complex64", ([1 + 2j, -1j, 3], [2 - 1j, 4, 0.5j]),
     {"Sum": ("complex64", [3 + 1j, 4 - 1j, 3 + 0.5j]),
      "Product": ("complex64", [4 + 3j, -4j, 1.5j]),
      "Average": ("raises", None), "Min": ("raises", None),
      "Max": ("raises", None)}))
# The same for the reducescatter (tests/test_torch_dtypes.py holds the
# port to the JAX engine on the CPU): the result's dtype and each rank's
# chunk, or "raises".  int16, int8 and uint8 sums wrap; complex 1 and 1+1j
# tie on the real part.
SCATTER_CASES = (
    ("bool", ([True, False, True, True], [True, True, False, False]),
     {"Sum": ("raises", None), "Average": ("raises", None),
      "Min": ("bool", [[True, False], [False, False]]),
      "Max": ("bool", [[True, True], [True, True]]),
      "Product": ("int32", [[1, 0], [0, 0]])}),
    ("int16", ([30000, -2, 1, 2], [30000, 5, -7, 3]),
     {"Sum": ("int16", [[-5536, 3], [-6, 5]]),
      "Average": ("float32", [[-2768.0, 1.5], [-3.0, 2.5]]),
      "Min": ("int16", [[30000, -2], [-7, 2]]),
      "Max": ("int16", [[30000, 5], [1, 3]]),
      "Product": ("int32", [[900000000, -10], [-7, 6]])}),
    ("int8", ([100, 3, -7, 4], [30, 90, 2, 50]),
     {"Sum": ("int8", [[-126, 93], [-5, 54]]),
      "Average": ("float32", [[-63.0, 46.5], [-2.5, 27.0]]),
      "Min": ("int8", [[30, 3], [-7, 4]]),
      "Max": ("int8", [[100, 90], [2, 50]]),
      "Product": ("int32", [[3000, 270], [-14, 200]])}),
    ("uint8", ([200, 3, 7, 200], [100, 90, 2, 100]),
     {"Sum": ("uint8", [[44, 93], [9, 44]]),
      "Average": ("float32", [[22.0, 46.5], [4.5, 22.0]]),
      "Min": ("uint8", [[100, 3], [2, 100]]),
      "Max": ("uint8", [[200, 90], [7, 200]]),
      "Product": ("uint32", [[20000, 270], [14, 20000]])}),
    ("complex64", ([1 + 2j, -1j, 3, 1], [2 - 1j, 4, 0.5j, 1 + 1j]),
     {"Sum": ("complex64", [[3 + 1j, 4 - 1j], [3 + 0.5j, 2 + 1j]]),
      "Average": ("complex64", [[1.5 + 0.5j, 2 - 0.5j],
                                [1.5 + 0.25j, 1 + 0.5j]]),
      "Min": ("complex64", [[1 + 2j, -1j], [0.5j, 1]]),
      "Max": ("complex64", [[2 - 1j, 4], [3, 1 + 1j]]),
      "Product": ("complex64", [[4 + 3j, -4j], [1.5j, 1 + 1j]])}))
E4_ROWS = 2 * 4096          # an expert dispatch's [2 x 4096, 4096] tokens
E4_BN = (32, 256, 56, 56)   # ResNet-50's first stage, per rank
E4_BN_TOL = 4e-2            # bf16 output and input gradient, |y| < 8


def _e4_grads(torch, shapes, dev, seed, rank):
    """Rank ``rank``'s integer-valued bf16 gradients (exact sums), in
    order, from its own generator: either rank can replay them."""
    gen = torch.Generator(device=dev).manual_seed(seed + 100 + rank)
    for shape in shapes:
        yield torch.randint(-8, 9, shape, generator=gen, device=dev,
                            dtype=torch.int16).to(torch.bfloat16)


def _e4_rows(torch, dev, seed, rank):
    """Rank ``rank``'s [2 x 4096, 4096] bf16 activation and ragged splits."""
    gen = torch.Generator(device=dev).manual_seed(seed + 200 + rank)
    x = torch.randn(E4_ROWS, 4096, generator=gen, device=dev).to(
        torch.bfloat16)
    a = int(torch.randint(0, E4_ROWS + 1, (1,), generator=gen,
                          device=dev).item())
    return x, [a, E4_ROWS - a]


def _e4_bn(torch, dev, seed, rank):
    gen = torch.Generator(device=dev).manual_seed(seed + 300 + rank)
    x = torch.randn(E4_BN, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(E4_BN, generator=gen, device=dev).to(torch.bfloat16)
    return x, g


def _e4_rank(args):
    """E4 on this rank (``e3_worker``'s second part): reducescatter (Sum,
    then Average) of the training configuration's gradients and an
    allgather of the Sum's shards back; an even and a ragged alltoall of
    an expert dispatch's activation; allgather_object, then a join in
    which rank 1 submits one allreduce fewer; SyncBatchNorm forward and
    backward; the promoting allreduce dtypes against the JAX engine's
    outcomes.  Each collective's launches and time are recorded."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import engine as engine_mod
    from horovod_tpu_torch.ops import fusion
    r, dev = hvd.rank(), hvd.device()
    eng = hvd.common.basics._get_state().engine
    seed = args.seed
    checks, timing = {}, {}

    def run(name, fn):
        """``fn()`` with the launch counts zeroed just before and read just
        after, and its time to the results on the card."""
        fusion.pack.launches = fusion.unpack.launches = 0
        d0, g0 = eng.pipeline_dispatches, eng.fused_groups
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timing[name] = dict(
            s=time.perf_counter() - t0,
            batches=eng.pipeline_dispatches - d0,
            groups=eng.fused_groups - g0, pack=fusion.pack.launches,
            unpack=fusion.unpack.launches)
        return out

    # Reducescatter and allgather of the gradient set.
    shapes = [sh for _, sh in _grad_shapes(torch, tl, args.train_layers, dev,
                                           seed + 1)]
    grads = list(_e4_grads(torch, shapes, dev, seed, r))
    nbytes = _nbytes(grads)
    rs = {}
    for op in ("Sum", "Average"):
        rs[op] = run(f"reducescatter {op}", lambda op=op: hvd.synchronize([
            hvd.reducescatter_async(g, name=f"e4.rs.{op}.{i}",
                                    op=getattr(hvd, op))
            for i, g in enumerate(grads)]))
    full = run("allgather", lambda: hvd.synchronize([
        hvd.allgather_async(t, name=f"e4.ag.{i}")
        for i, t in enumerate(rs["Sum"])]))
    del grads
    same = {"reducescatter Sum": True, "reducescatter Average": True,
            "allgather": True}
    for i, (g0, g1) in enumerate(zip(_e4_grads(torch, shapes, dev, seed, 0),
                                     _e4_grads(torch, shapes, dev, seed, 1))):
        total = g0 + g1                    # integers: exact in bf16
        n = total.shape[0] // 2
        mine = total[r * n:(r + 1) * n]
        same["reducescatter Sum"] &= torch.equal(rs["Sum"][i], mine)
        same["reducescatter Average"] &= torch.equal(rs["Average"][i],
                                                     mine / 2)
        same["allgather"] &= torch.equal(full[i], total)
    checks.update(same)
    del rs, full
    torch.cuda.empty_cache()
    # Alltoall, even and ragged, of an expert dispatch's activation.
    x, splits = _e4_rows(torch, dev, seed, r)
    even = run("alltoall", lambda: hvd.alltoall(x, name="e4.a2a"))
    ragged, rsplits = run("alltoall ragged", lambda: hvd.alltoall(
        x, splits=splits, name="e4.a2av"))
    del x
    peers = [_e4_rows(torch, dev, seed, q) for q in range(2)]
    half = E4_ROWS // 2
    checks["alltoall"] = torch.equal(even, torch.cat(
        [px[r * half:(r + 1) * half] for px, _ in peers]))
    rows = []
    for px, sp in peers:
        start = sum(sp[:r])
        rows.append(px[start:start + sp[r]])
    checks["alltoall ragged"] = (torch.equal(ragged, torch.cat(rows)) and
                                 rsplits.tolist() == [sp[r] for _, sp in
                                                      peers])
    del even, ragged, peers, rows
    # Objects, then a join in which rank 1 submits one allreduce fewer.
    objs = run("allgather_object", lambda: hvd.allgather_object(
        {"rank": r, "card": torch.cuda.get_device_name(dev)}))
    checks["allgather_object"] = [o["rank"] for o in objs] == [0, 1]
    v = torch.tensor([1.5, -2.0, 7.0], device=dev) * (r + 1)
    both = run("allreduce before join", lambda: hvd.allreduce(
        v, op=hvd.Sum, name="e4.join.sum"))
    checks["allreduce before join"] = both.tolist() == [4.5, -6.0, 21.0]
    if r == 0:
        alone = run("allreduce while rank 1 is joined", lambda: hvd.allreduce(
            v, op=hvd.Min, name="e4.join.min"))
        fill = engine_mod._join_fill_value(
            engine_mod.CollectiveType.ALLREDUCE, hvd.Min, torch.float32)
        checks["join fill value"] = torch.equal(
            alone, torch.minimum(v, torch.full_like(v, fill)))
    last = run("join", hvd.join)
    checks["join returns the last rank"] = last == 0
    # SyncBatchNorm against BatchNorm2d on the global batch.
    bn = hvd.SyncBatchNorm(E4_BN[1]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 301)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(E4_BN[1], generator=gen,
                                              device=dev))
        bn.bias.copy_(0.1 * torch.randn(E4_BN[1], generator=gen, device=dev))
    ref_bn = torch.nn.BatchNorm2d(E4_BN[1]).to(dev)
    ref_bn.load_state_dict(bn.state_dict())
    xb, gy = _e4_bn(torch, dev, seed, r)
    xb.requires_grad_()

    def bn_step():
        y = bn(xb)
        y.backward(gy)
        return y
    y = run("SyncBatchNorm forward and backward", bn_step)
    ins = [_e4_bn(torch, dev, seed, q) for q in range(2)]
    xr = torch.cat([a for a, _ in ins]).float().requires_grad_()
    yr = ref_bn(xr)
    yr.backward(torch.cat([g for _, g in ins]).float())
    rows = slice(r * E4_BN[0], (r + 1) * E4_BN[0])
    bn_err = dict(
        y=(y.float() - yr[rows]).abs().max().item(),
        dx=(xb.grad.float() - xr.grad[rows]).abs().max().item(),
        mean=(bn.running_mean - ref_bn.running_mean).abs().max().item(),
        var=(bn.running_var - ref_bn.running_var).abs().max().item())
    checks["SyncBatchNorm"] = (bn_err["y"] <= E4_BN_TOL
                               and bn_err["dx"] <= E4_BN_TOL
                               and bn_err["mean"] <= 1e-3
                               and bn_err["var"] <= 1e-3)
    del ins, xr, yr, y
    xb.grad = None              # the first call's time holds the warm-up
    run("SyncBatchNorm forward and backward, second call", bn_step)
    del xb
    # The promoting dtypes of an allreduce and a reducescatter against the
    # JAX engine's outcomes.
    promote = {}
    for what, fn, cases in (("allreduce", hvd.allreduce, PROMOTE_CASES),
                            ("reducescatter", hvd.reducescatter,
                             SCATTER_CASES)):
        for name, values, outcomes in cases:
            for op, (want_dt, want) in outcomes.items():
                t = torch.tensor(values[r], dtype=getattr(torch, name),
                                 device=dev)
                try:
                    got = fn(t, op=getattr(hvd, op),
                             name=f"e4.dt.{what}.{name}.{op}")
                    got = (str(got.dtype)[6:], got.cpu().tolist())
                except TypeError:
                    got = ("raises", None)
                if want is not None and what == "reducescatter":
                    want = want[r]
                promote[f"{what} {name} {op}"] = got == (want_dt, want)
        checks[f"promoting dtypes ({what})"] = all(
            v for k, v in promote.items() if k.startswith(what))
    return dict(
        rank=r, checks=checks, timing=timing, bn_err=bn_err,
        promote=promote, grad_bytes=nbytes, leaves=len(shapes),
        card=torch.cuda.get_device_name(dev))


def e4_phase(launch, card):
    """E4: the new collectives on two ranks at the training
    configuration's full width (``_e4_rank``, in ``e3_e5_launch``'s
    world): every check on both ranks, and pack launches = unpack launches
    = the dtype groups of the collective's batches (the counts zeroed just
    before each)."""
    results, route, wall = launch
    if results is None:
        return False, None
    results = [res["e4"] for res in results]
    ok = True
    for res in results:
        for what, good in res["checks"].items():
            ok = ok and good
            if not good or res["rank"] == 0:
                print(f"e4: rank {res['rank']}: {what}: "
                      f"{'PASS' if good else 'FAIL'}", flush=True)
        bad = [k for k, v in res["promote"].items() if not v]
        if bad:
            print(f"e4: rank {res['rank']}: promoting dtypes that differ "
                  f"from the JAX engine: {bad}", flush=True)
    a = results[0]
    e = a["bn_err"]
    print(f"e4: SyncBatchNorm {list(E4_BN)} bf16 a rank against "
          f"BatchNorm2d on the global batch: max_abs_err y {e['y']:.3e}, "
          f"dx {e['dx']:.3e} (tolerance {E4_BN_TOL}), running mean "
          f"{e['mean']:.3e}, var {e['var']:.3e} (1e-3)", flush=True)
    launches = {"pack": 0, "unpack": 0}
    for name, t in a["timing"].items():
        # A joined rank runs its peer's allreduce inside join().
        counts_ok = all(
            res["timing"][name]["pack"] == res["timing"][name]["unpack"]
            == res["timing"][name]["groups"]
            and (res["timing"][name]["batches"] > 0 or name == "join")
            for res in results if name in res["timing"])
        ok = ok and counts_ok
        launches["pack"] += t["pack"]
        launches["unpack"] += t["unpack"]
        gb = a["grad_bytes"] / 1e9 if "reducescatter" in name or \
            name == "allgather" else None
        print(f"e4: {name}: {t['s'] * 1e3:.1f} ms on rank 0"
              + (f" ({gb:.3f} GB of gradients a rank)" if gb else "")
              + f"; batches {t['batches']}, dtype groups {t['groups']}, "
              f"pack/unpack launches {t['pack']}/{t['unpack']} -> "
              f"{'PASS' if counts_ok else 'FAIL'} [{card}; two ranks on "
              f"{route}, no NVLink figure]", flush=True)
    print(f"e4: E4 on rank 0 in {results[0]['wall']:.1f} s of the launch's "
          f"{wall:.1f} s -> {'PASS' if ok else 'FAIL'}", flush=True)
    return ok, launches


def e3_e5_launch(torch, layers, seed, timeout_s=None):
    """E3, E4 and E5's one launch of two ranks (``e3_worker``):
    ``(results, route, wall)`` for ``two_rank_phase``, ``e4_phase`` and
    ``e5_phase``."""
    return launch_ranks(torch, "--e3-worker", layers, seed,
                        timeout_s or E3_E5_TIMEOUT_S)


def two_rank_phase(launch, layers):
    """E3: the training main path on two ranks over NCCL, one process each,
    started by the port's launcher (``e3_e5_launch``)."""
    import numpy as np
    results, route, wall = launch
    if results is None:
        return False, None
    results = [res["e3"] for res in results]
    a, b = results
    print(f"e3: two ranks ({route}) finished E3 in {a['wall']:.1f} s of "
          f"the launch's {wall:.1f} s; broadcast of "
          f"{a['leaves']} parameters {a['bcast_s'] * 1e3:.1f} ms; parameters "
          f"differed before it: {a['sums_before'] != b['sums_before']}",
          flush=True)
    ok = a["sums_before"] != b["sums_before"] and \
        a["sums_bcast"] == b["sums_bcast"]
    mod_ok = (all(x != y for x, y in zip(a["mod_before"], b["mod_before"]))
              and a["mod_bcast"] == b["mod_bcast"] == a["mod_before"])
    ok = ok and mod_ok
    print(f"e3: broadcast_parameters of a module with a buffer of each of "
          f"{', '.join(BYTE_DTYPES)} (and a float32 weight): rank 1 holds "
          f"rank 0's bytes after it: {mod_ok} -> "
          f"{'PASS' if mod_ok else 'FAIL'}", flush=True)
    want_flash = [layers * TRAIN_STEPS] * 3
    for i, (sa, sb) in enumerate(zip(a["steps"], b["steps"])):
        same = sa["sums"] == sb["sums"]
        bound = 12 + -(-sa["slots"] // 8)
        per_round = sa["bytes"] / max(1, sa["rounds"])
        warm = i == 0 or (sa["full_announces"] == 0 and sa["misses"] == 0
                          and sa["hits"] >= a["leaves"]
                          and per_round <= bound)
        launches_ok = all(s["pack"] == s["unpack"] == s["dtype_groups"]
                          == s["batches"] > 0 for s in (sa, sb))
        ok = ok and same and warm and launches_ok
        print(f"e3: step {i + 1}: loss rank0 {sa['loss']:.6f} rank1 "
              f"{sb['loss']:.6f}; parameters bitwise equal across ranks: "
              f"{same}; step {sa['s'] * 1e3:.1f} / {sb['s'] * 1e3:.1f} ms; "
              f"rounds {sa['rounds']}, cache hits {sa['hits']}, misses "
              f"{sa['misses']}, full announces {sa['full_announces']}, "
              f"{per_round:.2f} B a round (warm bound 12 + "
              f"ceil({sa['slots']} slots / 8) = {bound} B); batches "
              f"{sa['batches']} / {sb['batches']}, pack/unpack launches "
              f"{sa['pack']}/{sa['unpack']} (= batches x 1 dtype group) -> "
              f"{'PASS' if same and warm and launches_ok else 'FAIL'}",
              flush=True)
    for res in results:
        falls = np.isfinite([s["loss"] for s in res["steps"]]).all() and \
            res["steps"][-1]["loss"] < res["steps"][0]["loss"]
        flash_ok = res["flash"] == want_flash
        ok = ok and falls and flash_ok
        print(f"e3: rank {res['rank']} on {res['device']} ({res['card']}): "
              f"loss finite and lower at step {TRAIN_STEPS} than at step 1: "
              f"{falls}; flash launches fwd/dq/dkv {res['flash']} (= "
              f"{layers} layers x {TRAIN_STEPS} steps expected)", flush=True)
    step_ms = sorted(s["s"] for s in a["steps"])[TRAIN_STEPS // 2] * 1e3
    print(f"e3: median step {step_ms:.1f} ms on rank 0 over {route}: a "
          f"socket-transport two-rank figure on one card, not an NVLink or "
          f"InfiniBand one", flush=True)
    return ok, dict(pack=a["pack"], unpack=a["unpack"], step_ms=step_ms,
                    route=route)


# E5: sequence-parallel training at the full max_seq split over two ranks.
E5_SEQ = 8192            # Llama-3-8B's max_seq: 4,096 tokens a rank at sp=2
E5_CHECK_SEQ = 4096      # the gradient check's whole sequence
E5_STEPS = 2             # cut from 3 in PR 18: the script's time
# Ring against Ulysses, step 1, relative: bf16 activations, attention by
# other kernels' schedules (sound runs read 0 and 1.1e-5).
E5_LOSS_TOL = 1e-3
# E3, E4 and E5 share one launch (PR 18): one world formation for three.
E3_E5_TIMEOUT_S = 900


def _clone_tree(tree):
    """The parameter tree's leaves as fresh leaves that require grad (no
    optimizer hooks on them)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def _e5_rank(args):
    """E5 on this rank (``e3_worker``'s third part): the training main
    path with the sequence split over ``make_mesh({"sp": 2})``.  From the
    weights broadcast from rank 0: the gradient check at E5_CHECK_SEQ
    (ring, then Ulysses: the optimizer's averaged gradients before
    ``step()`` against a single-rank full-sequence step on rank 0), then
    E5_STEPS steps with ``sp_impl="ring"`` and E5_STEPS with "ulysses" at
    E5_SEQ, each from the broadcast weights, with the launch counts zeroed
    just before each step and read just after, the exchange times (CUDA
    events around each exchange's wait, ``mesh.timing``) and the
    parameters' checksums."""
    import dataclasses
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    from horovod_tpu_torch.common.basics import cuda_module_loading
    loading = cuda_module_loading()

    def progress(what):
        print(f"e5 rank {r}: {what} at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    t_start = time.perf_counter()
    mesh = parallel.make_mesh({"sp": n})
    progress("mesh made")
    ring = tl.llama3_8b(n_layers=args.train_layers, sp_impl="ring")
    ulysses = dataclasses.replace(ring, sp_impl="ulysses")
    params = tl.init_params(ring, torch.Generator(device=dev).manual_seed(
        args.seed + 1 + 1000 * r))
    named = list(tl.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    start = [t.detach().clone() for _, t in named]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
        named_parameters=named)

    def restore():
        with torch.no_grad():
            for (_, t), s0 in zip(named, start):
                t.copy_(s0)

    def batch(T, seed):
        """The same B x T tokens on every rank, and this rank's shard."""
        toks = torch.from_numpy(np.random.RandomState(seed).randint(
            0, ring.vocab_size, (TRAIN_BATCH, T + 1)).astype(np.int64)).to(
                dev)
        x, y = toks[:, :-1], toks[:, 1:]
        c = T // n
        return (x, y), tuple(a[:, r * c:(r + 1) * c].contiguous()
                             for a in (x, y))

    # The gradient check: rank 0's single-rank full-sequence reference
    # first, on clones without hooks, while rank 1 waits.
    (xf, yf), (xs, ys) = batch(E5_CHECK_SEQ, args.seed + 50)
    ref = None
    if r == 0:
        ref_params = _clone_tree(params)
        leaves = [t for _, t in tl.named_parameters(ref_params)]
        ref = torch.autograd.grad(tl.loss_fn(ref_params, xf, yf, ring),
                                  leaves)
        del ref_params, leaves
        torch.cuda.empty_cache()
    progress("reference gradients done")
    grad_check = {}
    for cfg in (ring, ulysses):
        opt.zero_grad()
        tl.loss_fn(params, xs, ys, cfg, mesh).backward()
        opt.synchronize()
        if r == 0:
            worst = 0.0
            for (_, t), g in zip(named, ref):
                a, b = t.grad.float(), g.float()
                rel = (a - b).abs().max().item() / max(
                    b.abs().max().item(), 1e-30)
                if not bool(torch.isfinite(a).all()):
                    rel = float("inf")
                worst = max(worst, rel)
            grad_check[cfg.sp_impl] = worst
        with opt.skip_synchronize():
            opt.step()
        restore()
        progress(f"gradient check ({cfg.sp_impl}) done")
    del ref
    torch.cuda.empty_cache()

    _, (x, y) = batch(E5_SEQ, args.seed + 60)
    runs = {}
    for cfg in (ring, ulysses):
        restore()
        step = tl.make_train_step(cfg, opt, mesh)
        steps = []
        for _ in range(E5_STEPS):
            fa.flash_attention_fwd.launches = 0
            fa.flash_attention_bwd.launches_dq = 0
            fa.flash_attention_bwd.launches_dkv = 0
            mesh.timing = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = step(params, x, y).item()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            marks, mesh.timing = mesh.timing, None
            steps.append(dict(
                loss=loss, s=dt, exchanges=len(marks),
                exchange_ms=parallel.timed_ms(marks),
                launches=[fa.flash_attention_fwd.launches,
                          fa.flash_attention_bwd.launches_dq,
                          fa.flash_attention_bwd.launches_dkv],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                sums=_checksum(torch, named)))
            progress(f"{cfg.sp_impl} step {len(steps)} done")
        runs[cfg.sp_impl] = steps
    mesh.shutdown()
    return dict(
        rank=r, size=n, device=str(dev), card=torch.cuda.get_device_name(dev),
        loading=loading, grad_check=grad_check, runs=runs)


def e3_worker(args):
    """One rank of E3, E4 and E5, started by ``e3_e5_launch`` through the
    port's launcher (one world formation for the three): ``_e3_rank``,
    ``_e4_rank``, ``_e5_rank`` in turn, each part's memory freed before
    the next.  A hang is a failure: every thread's stack goes to the result
    directory before the launch's timeout kills the ranks.  Writes
    ``rank<HOROVOD_RANK>.json`` (``{"e3": ..., "e4": ..., "e5": ...}``) in
    ``args.e3_worker``."""
    import faulthandler
    import gc
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    torch.backends.cuda.matmul.allow_tf32 = False
    stacks = open(os.path.join(args.e3_worker, "stacks"
                               f"{os.environ['HOROVOD_RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(E3_E5_TIMEOUT_S - 60, exit=False,
                                      file=stacks)
    hvd.init()
    res = {}
    for part, fn in (("e3", _e3_rank), ("e4", _e4_rank), ("e5", _e5_rank)):
        t0 = time.perf_counter()
        res[part] = fn(args)
        res[part]["wall"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    r = hvd.rank()
    hvd.shutdown()
    faulthandler.cancel_dump_traceback_later()
    stacks.close()
    _write_result(args.e3_worker, res)
    print(f"e3-e5 rank {r}: done", flush=True)
    return 0


def e5_phase(launch, layers, card):
    """E5: sequence-parallel training on two ranks through the port's
    launcher (``_e5_rank``), with the optimizer's hooks live: parameters
    bitwise equal across ranks after every step, finite losses, the ring's
    and Ulysses' step-1 losses within E5_LOSS_TOL, the gradients within
    GRAD_TOL of a single-rank step, and the launch counts of the ring's
    schedule: on rank r of n, per step, the forward ``layers x (r + 1)``
    times and dq, dk/dv ``layers x (n - r)`` times each; Ulysses
    ``layers`` each.  (``_e5_rank``, in ``e3_e5_launch``'s world.)"""
    import numpy as np
    results, route, wall = launch
    if results is None:
        return False, None
    results = [res["e5"] for res in results]
    n, a = len(results), results[0]
    modes = [res["loading"] for res in results]
    ok = all(m == "EAGER" for m in modes)
    print(f"e5: the ranks' CUDA module loading {modes} (EAGER: a lazy "
          f"first launch beside a spinning "
          f"collective can deadlock) -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    for impl in ("ring", "ulysses"):
        for i, steps in enumerate(zip(*(res["runs"][impl]
                                        for res in results))):
            same = len({str(st["sums"]) for st in steps}) == 1
            finite = all(np.isfinite(st["loss"]) for st in steps)
            launches_ok = True
            for res, st in zip(results, steps):
                rr = res["rank"]
                want = ([layers * (rr + 1)] + [layers * (n - rr)] * 2
                        if impl == "ring" else [layers] * 3)
                launches_ok = launches_ok and st["launches"] == want
            ok = ok and same and finite and launches_ok
            step_ms = " / ".join(f"{st['s'] * 1e3:.1f}" for st in steps)
            exch_ms = " / ".join(f"{st['exchange_ms']:.1f}" for st in steps)
            print(f"e5: {impl} step {i + 1}: losses "
                  f"{[round(st['loss'], 6) for st in steps]} (each rank's "
                  f"own {E5_SEQ // n:,} tokens a row); parameters bitwise "
                  f"equal across ranks: {same}; step {step_ms} ms; "
                  f"{steps[0]['exchanges']} exchanges taking {exch_ms} ms; "
                  f"flash launches fwd/dq/dkv "
                  f"{[st['launches'] for st in steps]} -> "
                  f"{'PASS' if same and finite and launches_ok else 'FAIL'}",
                  flush=True)
    for res in results:
        l_ring = res["runs"]["ring"][0]["loss"]
        l_uly = res["runs"]["ulysses"][0]["loss"]
        rel = abs(l_ring - l_uly) / max(abs(l_uly), 1e-30)
        agree = rel <= E5_LOSS_TOL
        ok = ok and agree
        print(f"e5: rank {res['rank']}: step-1 loss ring {l_ring:.6f} "
              f"Ulysses {l_uly:.6f}, relative difference {rel:.3e} (tol "
              f"{E5_LOSS_TOL:g}: bf16 activations, attention by other "
              f"kernels' schedules) -> {'PASS' if agree else 'FAIL'}",
              flush=True)
    for impl, worst in a["grad_check"].items():
        good = worst <= GRAD_TOL
        ok = ok and good
        print(f"e5: gradient check ({impl}) at T={E5_CHECK_SEQ} "
              f"({E5_CHECK_SEQ // n:,} a rank): the optimizer's averaged "
              f"gradients against a single-rank full-sequence step on rank "
              f"0, worst max_rel_err {worst:.3e} over "
              f"{layers * 9 + 3} leaves (tol {GRAD_TOL:g} relative to the "
              f"leaf's largest reference gradient) -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    summary = {}
    for impl in ("ring", "ulysses"):
        steps = a["runs"][impl]
        med = sorted(st["s"] for st in steps)[len(steps) // 2] * 1e3
        exch = sorted(st["exchange_ms"] for st in steps)[len(steps) // 2]
        peak = max(st["peak_gib"] for res in results
                   for st in res["runs"][impl])
        summary[impl] = dict(step_ms=med, exchange_ms=exch, peak_gib=peak)
        print(f"e5: {impl}: median step {med:.1f} ms on rank 0 "
              f"({TRAIN_BATCH * E5_SEQ / med * 1e3:.1f} tokens/s over both "
              f"ranks), exchange {exch:.1f} ms a step (CUDA events around "
              f"the waits), peak memory {peak:.2f} GiB a rank [{card}; two "
              f"ranks on {route}]", flush=True)
    print(f"e5: E5 on rank 0 in {a['wall']:.1f} s of the launch's "
          f"{wall:.1f} s -> {'PASS' if ok else 'FAIL'}", flush=True)
    launches = [sum(st["launches"][k] for impl in ("ring", "ulysses")
                    for st in a["runs"][impl]) for k in range(3)]
    return ok, dict(launches=launches, summary=summary)


# ---------------------------------------------------------------- E6: models
# The model families at their published widths (horovod_tpu_torch/models).
RESNET_BATCH = 32        # a rank: examples/resnet_synthetic.py:42
RESNET_STEPS = 6
RESNET_LR = 0.01         # SGD, momentum 0.9: examples/resnet_synthetic.py:88
BERT_BATCH, BERT_SEQ, BERT_MASK = 8, 512, 0.15
# The gradient check's sequence: the plain attention under autograd keeps
# dense [B, H, T, T] float32 scores in all 24 layers.
BERT_CHECK_SEQ = 256
# The wq/wk gradients of a randomly initialised BERT are sums over
# near-uniform attention rows that nearly cancel, so the bf16 rounding of
# ds (the Pallas kernels' own: horovod_tpu/ops/flash_attention.py:211,
# 265) is large beside them: they are held by their direction.
QK_COS_TOL = 0.9
VIT_BATCH = 32
GPT2_BATCH, GPT2_SEQ = 8, 1024
GEN_BATCH, GEN_PROMPT, GEN_TOKENS = 4, 16, 32
MODEL_STEPS = 3
MODEL_LR = 0.5
MNIST_BATCH = 64         # a rank
E6_TIMEOUT_S = 600
# The cached decode against the flash forward, relative to the largest
# logit: bf16 activations through 12 layers by other kernels.
DECODE_TOL = 5e-2


def _flash_counts(fa):
    return [fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv]


def _zero_flash(fa):
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0


def _sgd(torch, hvd, named, lr, momentum=0.0):
    return hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=lr, momentum=momentum),
        named_parameters=named)


def _timed_steps(torch, fa, step, n):
    """``n`` calls of ``step() -> loss`` with the flash counts zeroed just
    before: ``(losses, seconds, launches [fwd, dq, dkv])``."""
    _zero_flash(fa)
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return losses, times, _flash_counts(fa)


def _kernel_vs_plain_grads(torch, fa, mod, named, loss_of):
    """Every leaf's gradient of ``loss_of()`` through the kernels against
    the same with ``mod``'s attention on the plain version under autograd
    (dense, p and ds in float32): ``(loss kernel, loss plain, {leaf:
    (max_rel_err, cosine)}, relative error of the whole gradient)``."""
    def grads():
        for _, t in named:
            t.grad = None
        loss = loss_of()
        loss.backward()
        g = {n: t.grad.detach().float() for n, t in named}
        for _, t in named:
            t.grad = None
        return loss.item(), g

    loss_k, g_k = grads()
    kernel = mod.flash_attention
    mod.flash_attention = lambda q, k, v, causal: \
        fa.flash_attention_plain(q, k, v, causal=causal)[0]
    try:
        loss_p, g_p = grads()
    finally:
        mod.flash_attention = kernel
    leaves, diff2, ref2 = {}, 0.0, 0.0
    for n in g_k:
        a, b = g_k[n], g_p[n]
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if not bool(torch.isfinite(a).all()):
            rel = float("inf")
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()
        leaves[n] = (rel, cos)
        diff2 += (a - b).square().sum().item()
        ref2 += b.square().sum().item()
    return loss_k, loss_p, leaves, (diff2 / max(ref2, 1e-30)) ** 0.5


def _mlm_batch(torch, cfg, batch, seq, rate, seed, dev):
    import numpy as np
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq))
    tgts = rng.randint(0, cfg.vocab_size, (batch, seq))
    mask = (rng.rand(batch, seq) < rate).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (toks, tgts, mask))


def resnet_phase(torch, hvd, fa, seed, card, flush):
    """E6, ResNet-50 at size 1: steps on one fixed batch, images/s, the
    weight permute's cost and a profiled step."""
    import numpy as np
    from horovod_tpu_torch.models import resnet as tr
    hvd.init()
    dev = hvd.device()
    cfg = tr.ResNetConfig()
    params, stats = tr.init_params(cfg, torch.Generator(
        device=dev).manual_seed(seed + 30))
    named = list(tr.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    step = tr.make_train_step(cfg, _sgd(torch, hvd, named, RESNET_LR, 0.9))
    x, y = (torch.from_numpy(a).to(dev) for a in tr.synthetic_batch(
        RESNET_BATCH, 224, cfg.num_classes, seed + 31))
    print(f"models: resnet50 (depth {cfg.depth}, width {cfg.width}, 224², "
          f"{cfg.num_classes} classes), {sum(t.numel() for _, t in named):,}"
          f" float32 parameters in {len(named)} leaves, bf16 compute, "
          f"channels_last activations, batch {RESNET_BATCH}, SGD lr "
          f"{RESNET_LR} momentum 0.9", flush=True)
    state = {"stats": stats}

    def one():
        loss, state["stats"] = step(params, state["stats"], x, y)
        return loss

    ex0 = tr.cross_rank_moments.exchanges
    losses, times, _ = _timed_steps(torch, fa, one, RESNET_STEPS)
    falls = bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
    stats_ok = all(bool(torch.isfinite(t).all()) for _, t in
                   tr.named_parameters(state["stats"]))
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    print(f"models: resnet50 losses {[round(v, 5) for v in losses]}, step "
          f"times {[round(t * 1e3, 2) for t in times]} ms; median of steps "
          f"2-{RESNET_STEPS} {step_s * 1e3:.2f} ms = "
          f"{RESNET_BATCH / step_s:.1f} images/s [{card}]; loss finite and "
          f"lower at step {RESNET_STEPS} than at step 1: {falls}; running "
          f"statistics finite: {stats_ok}; batch-norm exchanges "
          f"{tr.cross_rank_moments.exchanges - ex0} (0 at size 1)",
          flush=True)
    # What the HWIO -> channels_last permute of the 53 convolution weights
    # costs a step: forward copy and backward copy of the gradient, against
    # the bf16 cast alone (which the JAX model does as well).
    convs = [t for _, t in named if t.dim() == 4]
    cl = torch.channels_last

    def permute_cast():
        outs = [w.permute(3, 2, 0, 1).to(cfg.compute_dtype, memory_format=cl)
                for w in convs]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    def cast_only():
        outs = [w.to(cfg.compute_dtype) for w in convs]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    # The card's time alone (lead): the host's 2 x 53 small enqueues would
    # otherwise fall inside the events.
    permute_ms = time_ms(torch, permute_cast, flush, lead=True)
    cast_ms = time_ms(torch, cast_only, flush, lead=True)
    for _, t in named:
        t.grad = None
    print(f"models: resnet50 weight permute HWIO -> channels_last with the "
          f"bf16 cast, forward + backward, {permute_ms:.4f} ms a step; the "
          f"cast alone {cast_ms:.4f} ms; the permute adds "
          f"{permute_ms - cast_ms:.4f} ms "
          f"({(permute_ms - cast_ms) / (step_s * 1e3):.2%} of the step) "
          f"[{card}]", flush=True)
    try:
        profile_call(torch, "resnet50 step", one)
    except Exception as exc:  # noqa: BLE001 - a measurement, not a check
        print(f"profile: failed ({type(exc).__name__}: {exc}); busy share "
              f"not measured", flush=True)
    del params, state, named, step
    torch.cuda.empty_cache()
    return falls and stats_ok, dict(step_ms=step_s * 1e3,
                                    images_s=RESNET_BATCH / step_s,
                                    permute_ms=permute_ms - cast_ms)


def transformer_phase(torch, hvd, fa, seed, card):
    """E6, BERT-Large, ViT-B/16 and GPT-2 at size 1: BERT's gradients
    through the kernels against the plain attention, MODEL_STEPS steps of
    each with the flash launches (each kernel once a layer and step), and
    GPT-2's greedy generation with its cached logits against the flash
    forward's."""
    import numpy as np
    from horovod_tpu_torch.models import bert as tb, gpt2 as tg, vit as tv
    hvd.init()
    dev = hvd.device()
    ok, launches, summary = True, [0, 0, 0], {}

    def run(name, cfg, named, step, steps=MODEL_STEPS):
        nonlocal ok
        losses, times, counts = _timed_steps(torch, fa, step, steps)
        want = [cfg.n_layers * steps] * 3
        good = bool(np.isfinite(losses).all()) and counts == want
        ok = ok and good
        for i in range(3):
            launches[i] += counts[i]
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        summary[name] = dict(step_ms=step_s * 1e3)
        print(f"models: {name} losses {[round(v, 5) for v in losses]}, "
              f"step times {[round(t * 1e3, 2) for t in times]} ms, median "
              f"of steps 2-{steps} {step_s * 1e3:.2f} ms; flash launches "
              f"fwd/dq/dkv {counts} (= {cfg.n_layers} layers x {steps} "
              f"steps each) -> {'PASS' if good else 'FAIL'} [{card}]",
              flush=True)
        return step_s

    # BERT-Large: 24 layers, d 1024, T 512, B 8, a 15 % mask.
    cfg = tb.bert_large()
    params = tb.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 40))
    named = list(tb.named_parameters(params))
    toks, tgts, mask = _mlm_batch(torch, cfg, BERT_BATCH, BERT_SEQ,
                                  BERT_MASK, seed + 41, dev)
    c = BERT_CHECK_SEQ
    loss_k, loss_p, leaves, whole = _kernel_vs_plain_grads(
        torch, fa, tb, named, lambda: tb.mlm_loss_fn(
            params, toks[:, :c], tgts[:, :c], mask[:, :c], cfg))
    qk = {n: v for n, v in leaves.items() if n.endswith((".wq", ".wk"))}
    rest = {n: v for n, v in leaves.items() if n not in qk}
    worst_rest = max((v[0], n) for n, v in rest.items())
    worst_qk = max((v[0], n) for n, v in qk.items())
    low_cos = min((v[1], n) for n, v in qk.items())
    good = (whole <= GRAD_TOL and worst_rest[0] <= GRAD_TOL
            and low_cos[0] >= QK_COS_TOL)
    ok = ok and good
    print(f"models: bert-large gradients through the kernels against the "
          f"plain attention under autograd at T={c} (cut from {BERT_SEQ}: "
          f"the plain attention keeps dense scores), {len(leaves)} leaves, "
          f"loss kernel {loss_k:.6f} plain {loss_p:.6f}: the whole "
          f"gradient's relative error {whole:.3e} (tol {GRAD_TOL:g}); "
          f"worst max_rel_err {worst_rest[0]:.3e} at {worst_rest[1]} "
          f"over the {len(rest)} leaves but wq/wk (tol {GRAD_TOL:g} "
          f"relative to the leaf's largest reference gradient); wq/wk "
          f"worst max_rel_err {worst_qk[0]:.3e} at {worst_qk[1]}, lowest "
          f"cosine {low_cos[0]:.5f} at {low_cos[1]} (tol {QK_COS_TOL:g}: "
          f"their gradients are ~1 % of wv's, sums over near-uniform "
          f"attention rows that cancel, and the kernels round ds to bf16 "
          f"before ds.k as the Pallas kernels do) -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    step = tb.make_train_step(cfg, _sgd(torch, hvd, named, MODEL_LR))
    print(f"models: bert-large {sum(t.numel() for _, t in named):,} bf16 "
          f"parameters, B={BERT_BATCH} T={BERT_SEQ}, "
          f"{int(mask.sum())} masked positions", flush=True)
    s = run("bert-large", cfg, named, lambda: step(params, toks, tgts, mask))
    summary["bert-large"]["tokens_s"] = BERT_BATCH * BERT_SEQ / s
    del params, named, step, toks, tgts, mask
    torch.cuda.empty_cache()

    # ViT-B/16: 224², 196 patches + CLS = 197 rows, B 32.
    cfg = tv.vit_b16()
    params = tv.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 42))
    named = list(tv.named_parameters(params))
    rng = np.random.RandomState(seed + 43)
    x = torch.from_numpy(rng.randn(VIT_BATCH, 224, 224, 3).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.n_classes, VIT_BATCH)).to(dev)
    step = tv.make_train_step(cfg, _sgd(torch, hvd, named, MODEL_LR))
    s = run("vit-b16", cfg, named, lambda: step(params, x, y))
    summary["vit-b16"]["images_s"] = VIT_BATCH / s
    del params, named, step, x, y
    torch.cuda.empty_cache()

    # GPT-2 (124M): T 1024, B 8, then a greedy generation.
    cfg = tg.gpt2()
    params = tg.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 44))
    named = list(tg.named_parameters(params))
    toks = torch.from_numpy(np.random.RandomState(seed + 45).randint(
        0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ + 1))).to(dev)
    step = tg.make_train_step(cfg, _sgd(torch, hvd, named, MODEL_LR))
    s = run("gpt2", cfg, named, lambda: step(params, toks[:, :-1],
                                             toks[:, 1:]))
    summary["gpt2"]["tokens_s"] = GPT2_BATCH * GPT2_SEQ / s
    prompt = toks[:GEN_BATCH, :GEN_PROMPT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tg.generate(params, prompt, GEN_TOKENS, cfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    with torch.no_grad():
        full = tg.forward(params, prompt, cfg)[:, -1]
    cache = tg.init_cache(cfg, prompt.shape[0], GEN_PROMPT, dev)
    for i in range(GEN_PROMPT):
        cached, cache = tg.decode_step(params, cache, prompt[:, i], i, cfg)
    rel = (cached - full).abs().max().item() / full.abs().max().item()
    same = int((cached.argmax(-1) == full.argmax(-1)).sum())
    good = (out.shape == (prompt.shape[0], GEN_TOKENS) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size and rel <= DECODE_TOL
            and torch.equal(out[:, 0], cached.argmax(-1).to(out.dtype)))
    ok = ok and good
    steps = GEN_PROMPT + GEN_TOKENS - 1
    summary["gpt2"].update(gen_ms_token=gen_s * 1e3 / GEN_TOKENS,
                           gen_ms_step=gen_s * 1e3 / steps)
    print(f"models: gpt2 greedy generate of {GEN_TOKENS} tokens from "
          f"{GEN_BATCH} x {GEN_PROMPT}-token prompts (fed a token at a time,"
          f" {steps} cached decode steps): {gen_s * 1e3:.1f} ms, "
          f"{gen_s * 1e3 / GEN_TOKENS:.2f} ms a generated token, "
          f"{gen_s * 1e3 / steps:.2f} ms a decode step [{card}]; row 0: "
          f"{out[0].tolist()}; the cached logits at the prompt's last "
          f"position against the flash forward's max_rel_err {rel:.3e} (tol "
          f"{DECODE_TOL:g} relative to the largest logit), greedy token "
          f"agrees on {same}/{prompt.shape[0]} rows -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    del params, named, step, toks, cache
    torch.cuda.empty_cache()
    return ok, launches, summary


def e6_worker(args):
    """One rank of E6's size-2 run, started by the port's launcher:
    ResNet-50 with the cross-rank batch norm, the MNIST convnet and
    BERT-Large, each from rank 0's broadcast parameters (rank 1 starts
    from other seeds) through ``DistributedOptimizer`` on this rank's own
    batch, BERT's with another mask count on each rank.  Each step's loss,
    time, engine counters, batch-norm exchanges and the parameters' (and
    ResNet's statistics') checksums go to ``rank<HOROVOD_RANK>.json`` in
    ``args.e6_worker``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as tb, mnist as tm
    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    eng = hvd.common.basics._get_state().engine
    ctl = eng.controller
    # The host's time inside the blocking batch-norm exchanges (the
    # negotiation, the allreduce and the wait for the peer).
    exchange_s = [0.0]
    world_mean = tr._world_mean

    def timed_world_mean(t, name):
        t0 = time.perf_counter()
        out = world_mean(t, name)
        exchange_s[0] += time.perf_counter() - t0
        return out

    tr._world_mean = timed_world_mean

    def counters():
        st = ctl.cache_stats
        return [eng.pipeline_dispatches, eng.fused_groups,
                st.hits + st.misses, fusion.pack.launches,
                fusion.unpack.launches, tr.cross_rank_moments.exchanges,
                exchange_s[0]]

    def gen(k):
        return torch.Generator(device=dev).manual_seed(args.seed + k
                                                       + 1000 * r)

    def run(named, step, n, extra=None):
        fusion.pack.launches = fusion.unpack.launches = 0
        _zero_flash(fa)
        steps = []
        for _ in range(n):
            c0 = counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            d = [b - a for a, b in zip(c0, counters())]
            steps.append(dict(
                loss=loss, s=dt, batches=d[0], groups=d[1], allreduces=d[2],
                pack=d[3], unpack=d[4], bn=d[5], bn_s=d[6],
                sums=_checksum(torch, named),
                stats=_checksum(torch, list(tr.named_parameters(extra())))
                if extra else None))
        return dict(steps=steps, flash=_flash_counts(fa),
                    pack=fusion.pack.launches, unpack=fusion.unpack.launches)

    res = dict(rank=r, device=str(dev), card=torch.cuda.get_device_name(dev))
    # ResNet-50 with the cross-rank batch norm.
    cfg = tr.ResNetConfig()
    params, stats = tr.init_params(cfg, gen(30))
    named = list(tr.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    step = tr.make_train_step(cfg, _sgd(torch, hvd, named, RESNET_LR, 0.9))
    x, y = (torch.from_numpy(a).to(dev) for a in tr.synthetic_batch(
        RESNET_BATCH, 224, cfg.num_classes, args.seed + 31 + r))
    state = {"stats": stats}

    def one():
        loss, state["stats"] = step(params, state["stats"], x, y)
        return loss

    res["resnet"] = run(named, one, MODEL_STEPS, lambda: state["stats"])
    res["resnet"]["bn_layers"] = len([n for n, _ in named
                                      if n.endswith("bn.scale")])
    del params, state, named, step, x, y
    torch.cuda.empty_cache()
    # The MNIST convnet.
    params = tm.init_params(gen(32))
    named = list(tm.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    step = tm.make_train_step(_sgd(torch, hvd, named, RESNET_LR, 0.9))
    x, y = (torch.from_numpy(a).to(dev) for a in tm.synthetic_batch(
        MNIST_BATCH, args.seed + 33 + r))
    res["mnist"] = run(named, lambda: step(params, x, y), MODEL_STEPS)
    del params, named, step, x, y
    # BERT-Large, another mask rate on each rank.
    cfg = tb.bert_large()
    params = tb.init_params(cfg, gen(40))
    named = list(tb.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    step = tb.make_train_step(cfg, _sgd(torch, hvd, named, MODEL_LR))
    toks, tgts, mask = _mlm_batch(torch, cfg, BERT_BATCH, BERT_SEQ,
                                  BERT_MASK * (1 - 0.5 * r),
                                  args.seed + 41 + r, dev)
    res["bert"] = run(named, lambda: step(params, toks, tgts, mask),
                      MODEL_STEPS - 1)
    res["bert"]["masked"] = int(mask.sum())
    res["bert"]["layers"] = cfg.n_layers
    del params, named, step
    hvd.shutdown()
    _write_result(args.e6_worker, res)
    print(f"e6 rank {r}: done", flush=True)
    return 0


def e6_phase(torch, seed, card, timeout_s=E6_TIMEOUT_S):
    """E6 at size 2, through the port's launcher (``e6_worker``): for each
    model, the parameters bitwise equal across the ranks after every step
    (and ResNet's running statistics), finite losses, pack = unpack
    launches = the dtype groups of the step's batches, ResNet's batch-norm
    exchanges (two a layer and step) and BERT's flash launches."""
    import numpy as np
    results, route, wall = launch_ranks(torch, "--e6-worker", 0, seed,
                                            timeout_s)
    if results is None:
        return False, None
    a, b = results
    ok = True
    for model in ("resnet", "mnist", "bert"):
        for i, (sa, sb) in enumerate(zip(a[model]["steps"],
                                         b[model]["steps"])):
            same = sa["sums"] == sb["sums"] and sa["stats"] == sb["stats"]
            finite = bool(np.isfinite([sa["loss"], sb["loss"]]).all())
            fused = all(s["pack"] == s["unpack"] == s["groups"] > 0
                        and s["batches"] > 0 for s in (sa, sb))
            good = same and finite and fused
            extra = ""
            if model == "resnet":
                want = 2 * a[model]["bn_layers"]
                good = good and sa["bn"] == sb["bn"] == want
                extra = (f"; batch-norm exchanges {sa['bn']} / {sb['bn']} "
                         f"(= 2 x {a[model]['bn_layers']} layers expected),"
                         f" {sa['bn_s'] * 1e3:.1f} ms of the step inside "
                         f"them on rank 0 (host clock around the blocking "
                         f"allreduces), running statistics bitwise equal: "
                         f"{sa['stats'] == sb['stats']}")
            ok = ok and good
            print(f"e6: {model} step {i + 1}: losses {sa['loss']:.5f} / "
                  f"{sb['loss']:.5f}; parameters bitwise equal across ranks:"
                  f" {sa['sums'] == sb['sums']}{extra}; step "
                  f"{sa['s'] * 1e3:.1f} / {sb['s'] * 1e3:.1f} ms; "
                  f"allreduces {sa['allreduces']}, engine batches "
                  f"{sa['batches']}, dtype groups {sa['groups']}, pack/"
                  f"unpack launches {sa['pack']}/{sa['unpack']} -> "
                  f"{'PASS' if good else 'FAIL'}", flush=True)
    layers = a["bert"]["layers"]
    want = [layers * len(a["bert"]["steps"])] * 3
    flash_ok = a["bert"]["flash"] == b["bert"]["flash"] == want
    masks = (a["bert"]["masked"], b["bert"]["masked"])
    ok = ok and flash_ok and masks[0] != masks[1]
    print(f"e6: bert masked positions {masks[0]} / {masks[1]} (unequal: the "
          f"loss divides by the global count); flash launches fwd/dq/dkv "
          f"{a['bert']['flash']} / {b['bert']['flash']} (= {layers} layers x "
          f"{len(a['bert']['steps'])} steps expected)", flush=True)
    med = {m: sorted(s["s"] for s in a[m]["steps"][1:])[
        len(a[m]["steps"][1:]) // 2] * 1e3 for m in ("resnet", "bert")}
    bn_ms = sorted(s["bn_s"] for s in a["resnet"]["steps"][1:])[
        len(a["resnet"]["steps"][1:]) // 2] * 1e3
    print(f"e6: median step of steps 2- on rank 0: resnet50 "
          f"{med['resnet']:.1f} ms "
          f"({2 * RESNET_BATCH / med['resnet'] * 1e3:.1f} images/s over both "
          f"ranks; {bn_ms:.1f} ms in its batch-norm exchanges), bert-large "
          f"{med['bert']:.1f} ms "
          f"[{card}; two ranks on {route}, no NVLink figure]; the launcher "
          f"run in {wall:.1f} s -> {'PASS' if ok else 'FAIL'}", flush=True)
    pack = sum(a[m]["pack"] for m in ("resnet", "mnist", "bert"))
    unpack = sum(a[m]["unpack"] for m in ("resnet", "mnist", "bert"))
    return ok, dict(pack=pack, unpack=unpack, flash=a["bert"]["flash"],
                    step_ms=med)


# ----------------------------------------------------------------- Adasum
# The dots against a float64 sum: |error| within DOTS_RTOL of |k|·|r| for
# k·r (its value may cancel to near zero), of the value for k·k and r·r.
DOTS_RTOL = 1e-5
ADASUM_ODD = 1_000_003         # an odd length: 16-byte loads and a tail


def adasum_phase(torch, ak, shapes, dev, seed, flush):
    """The Adasum kernels against their plain versions on the card: for
    each distinct size of the training configuration's gradients, the
    float32 halves of one (``kept`` the first half, ``received`` the
    second: a first halving round's segments), then an odd length and an
    empty tensor.  ``hvd_adasum_dots`` within DOTS_RTOL of a float64 sum
    and bitwise equal on a second call; ``hvd_adasum_combine`` bitwise
    equal to the plain version given the same triple, for both sides and in
    place.  CUDA-event times at the largest size (the card's time alone,
    L2 flushed) against the bound (bytes) and the library yardstick."""
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    sizes = sorted({math.prod(s) // 2 for _, s in shapes}) + [ADASUM_ODD, 0]
    ok, worst = True, {"dots": 0.0, "combine": 0.0}
    for n in sizes:
        g = torch.randn(2 * n, generator=gen, device=dev).to(
            torch.bfloat16).float()
        k, r = g[:n], g[n:]
        d1, d2 = ak.dots(k, r), ak.dots(k, r)
        kd, rd = k.double(), r.double()
        ref = torch.stack([kd @ rd, kd @ kd, rd @ rd])
        scale = torch.stack([(ref[1] * ref[2]).sqrt(), ref[1], ref[2]])
        rel = ((d1.double() - ref).abs() / scale.clamp_min(1e-300)).max()
        rel = float(rel) if n else float(d1.abs().max())
        same = bool(torch.equal(d1, d2))
        combined = []
        for is_low in (True, False):
            got = ak.combine(k, r, d1, is_low)
            plain = ak.combine_plain(k, r, d1, is_low, torch.empty_like(k))
            inplace = k.clone()
            ak.combine(inplace, r, d1, is_low, out=inplace)
            combined.append(torch.equal(got, plain)
                            and torch.equal(inplace, plain))
            cerr = _err(got, plain)
            worst["combine"] = max(worst["combine"], cerr)
        worst["dots"] = max(worst["dots"], rel)
        good = rel <= DOTS_RTOL and same and all(combined)
        ok = ok and good
        print(f"adasum[n={n}]: dots relative error {rel:.2e} (tolerance "
              f"{DOTS_RTOL:g}), bitwise on a second call: {same}; combine "
              f"bitwise the plain version (low, high side, in place): "
              f"{combined} -> {'PASS' if good else 'FAIL'}", flush=True)
        del g, k, r, kd, rd
    n = max(sizes)
    g = torch.randn(2 * n, generator=gen, device=dev).to(
        torch.bfloat16).float()
    k, r = g[:n], g[n:]
    tri = ak.dots(k, r)
    ca, cb = (float(c) for c in ak.coefficients(tri))
    out = torch.empty_like(k)
    res = {}
    for name, kern, plain, lib, nbytes in (
            ("dots", lambda: ak.dots(k, r), lambda: ak.dots_plain(k, r),
             lambda: (torch.dot(k, r), torch.dot(k, k), torch.dot(r, r)),
             8 * n + 12),
            ("combine", lambda: ak.combine(k, r, tri, True, out=out),
             lambda: ak.combine_plain(k, r, tri, True, out),
             lambda: torch.add(k.mul(ca), r, alpha=cb), 12 * n)):
        ms = time_ms(torch, kern, flush, lead=True)
        plain_ms = time_ms(torch, plain, flush, lead=True)
        lib_ms = time_ms(torch, lib, flush, lead=True)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by="bytes",
                         gbps=nbytes / ms / 1e6, max_abs_err=worst[name],
                         n=n)
        lib_name = ("three torch.dot" if name == "dots"
                    else "torch.add(k.mul(ca), r, alpha=cb)")
        print(f"adasum[{name}, n={n} float32]: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms ({lib_name}), bound {bound:.4f} ms "
              f"(bytes)", flush=True)
    del g, k, r, out
    torch.cuda.empty_cache()
    return ok, res


E7_RANKS = 4
E7_LOCAL = 2             # HOROVOD_HIERARCHICAL_LOCAL_SIZE: 2 slices of 2
E7_LAYERS = 1             # one layer keeps the whole script in its limit
E7_STEPS = 1              # one step keeps the whole script in its limit
# Adasum of four nearly orthogonal gradients is close to their sum, four
# times the average that E3's TRAIN_LR was chosen for.
E7_LR = TRAIN_LR / E7_RANKS
ADASUM_RTOL, ADASUM_ATOL = 1e-4, 1e-5
E7_TIMEOUT_S = 600
E7_HIER_FLAGS = ("--hierarchical-allreduce", "--hierarchical-allgather",
                 "--hierarchical-broadcast")


def _layer_shapes(cfg, attention_only=False):
    """One decoder layer's gradients at ``cfg``'s width, by name."""
    D, F = cfg.d_model, cfg.d_ff
    Q, K = cfg.n_heads * (D // cfg.n_heads), cfg.n_kv_heads * (
        D // cfg.n_heads)
    shapes = [("attn_norm", (D,)), ("mlp_norm", (D,)), ("wq", (D, Q)),
              ("wk", (D, K)), ("wv", (D, K)), ("wo", (Q, D))]
    if not attention_only:
        shapes += [("w1", (D, F)), ("w2", (F, D)), ("w3", (D, F))]
    return shapes


def _e7_tensors(torch, shapes, dev, seed, rank, kind):
    """Rank ``rank``'s tensors: integer-valued bf16 in [-3, 3] ("ints"),
    bf16 normal ("bf16") or float32 normal ("f32"), from its own seed."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7000 + 97 * rank)
    out = []
    for _, s in shapes:
        if kind == "ints":
            out.append(torch.randint(-3, 4, s, generator=gen, device=dev).to(
                torch.bfloat16))
        else:
            t = torch.randn(s, generator=gen, device=dev)
            out.append(t.to(torch.bfloat16) if kind == "bf16" else t)
    return out


def _adasum64(torch, vals):
    """The pairwise tree of ``parallel/adasum.py`` in float64."""
    vals = list(vals)

    def comb(a, b):
        ab, aa, bb = a @ b, a @ a, b @ b
        return ((1 - ab / (2 * aa + 1e-30)) * a
                + (1 - ab / (2 * bb + 1e-30)) * b)
    while len(vals) > 1:
        nxt = [comb(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt[-1] = comb(nxt[-1], vals[-1])
        vals = nxt
    return vals[0]


def e7_worker(args):
    """One rank of E7, started by ``e7_phase`` through the port's launcher
    with ``--hierarchical-allreduce --hierarchical-allgather
    --hierarchical-broadcast`` and ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``:
    (a) the two-level Sum/Average/Min/Max of an integer-valued bf16
    gradient set against the same submission with ``hierarchical=False``
    and against the sums this rank recomputes from every rank's seed;
    (b) two-level allgather and broadcast (the root in the other slice)
    against flat; (c) Adasum of a float32 gradient set, flat VHD and
    two-level, then the tree on a process set of 3 ranks, against the
    float64 tree of every rank's tensors; (d) ``DistributedOptimizer(SGD,
    op=hvd.Adasum)`` training Llama at full width from rank 0's broadcast
    weights, each rank its own batch, with the launch counts zeroed just
    before the steps and read just after.  Writes
    ``rank<HOROVOD_RANK>.json`` in ``args.e7_worker``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import adasum as ak
    from horovod_tpu_torch.ops import eager
    from horovod_tpu_torch.ops import flash_attention as fa
    import faulthandler
    torch.backends.cuda.matmul.allow_tf32 = False
    stacks = open(os.path.join(args.e7_worker, "stacks"
                               f"{os.environ['HOROVOD_RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(E7_TIMEOUT_S - 60, exit=False,
                                      file=stacks)
    hvd.init()
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    eng = hvd.common.basics._get_state().engine
    st = eng._slice_topology(0)
    res = dict(rank=r, size=n, device=str(dev),
               card=torch.cuda.get_device_name(dev),
               slices=[st.num_slices, st.local_size] if st else None,
               groups=eng._hier is not None)
    t_start = time.perf_counter()

    def progress(what):
        print(f"e7 rank {r}: {what} at {time.perf_counter() - t_start:.1f} "
              f"s", flush=True)

    def legs():
        return [eng.hier_dispatches, eng.hier_intra_legs,
                eng.hier_cross_legs, eng.hier_ag_dispatches,
                eng.hier_ag_intra_legs, eng.hier_ag_cross_legs,
                eng.hier_bcast_dispatches, eng.hier_bcast_intra_legs,
                eng.hier_bcast_cross_legs]

    cfg = tl.llama3_8b(n_layers=args.train_layers)
    layer = _layer_shapes(cfg)
    # (a) the two-level allreduce of an integer-valued bf16 gradient set.
    mine = _e7_tensors(torch, layer, dev, args.seed, r, "ints")
    # The exact results, from every rank's seed (small integers: exact in
    # bf16 and in any order of the sum).
    exact = {}
    for q in range(n):
        theirs = [t.float() for t in _e7_tensors(torch, layer, dev,
                                                  args.seed, q, "ints")]
        if not exact:
            exact = {op: [t.clone() for t in theirs]
                     for op in ("Sum", "Min", "Max")}
            continue
        for i, t in enumerate(theirs):
            exact["Sum"][i] += t
            exact["Min"][i] = torch.minimum(exact["Min"][i], t)
            exact["Max"][i] = torch.maximum(exact["Max"][i], t)
        del theirs
    exact["Average"] = [t / n for t in exact["Sum"]]
    res["set_bytes"] = _nbytes(mine)
    allreduce = {}
    for op in ("Sum", "Average", "Min", "Max"):
        want = [t.to(torch.bfloat16) for t in exact.pop(op)]
        c0 = legs()
        t0 = time.perf_counter()
        hier = eager.grouped_allreduce(mine, name=f"e7.h.{op}",
                                       op=getattr(hvd, op))
        torch.cuda.synchronize()
        hier_s = time.perf_counter() - t0
        c1 = legs()
        t0 = time.perf_counter()
        flat = eager.grouped_allreduce(mine, name=f"e7.f.{op}",
                                       op=getattr(hvd, op),
                                       hierarchical=False)
        torch.cuda.synchronize()
        flat_s = time.perf_counter() - t0
        allreduce[op] = dict(
            same=all(torch.equal(a, b) for a, b in zip(hier, flat)),
            right=all(torch.equal(a, b) for a, b in zip(hier, want)),
            legs=[b - a for a, b in zip(c0, c1)][:3],
            flat_legs=[b - a for a, b in zip(c1, legs())][:3],
            hier_s=hier_s, flat_s=flat_s,
            bits=_checksum(torch, enumerate(hier)))
        del hier, flat, want
    res["allreduce"] = allreduce
    progress("(a) two-level allreduce done")
    # (b) allgather and broadcast, the root in the other slice.
    attn = _layer_shapes(cfg, attention_only=True)[2:4]
    ag_in = _e7_tensors(torch, attn, dev, args.seed + 1, r, "bf16")
    want = [torch.cat(t) for t in zip(*[
        _e7_tensors(torch, attn, dev, args.seed + 1, q, "bf16")
        for q in range(n)])]
    c0 = legs()
    hier = eager.grouped_allgather(ag_in, name="e7.ag.h")
    c1 = legs()
    flat = [eager._engine().synchronize(h) for h in [
        eager._engine().enqueue(f"e7.ag.f.{i}",
                                eager.CollectiveType.ALLGATHER, t,
                                hierarchical=False) for i, t in
        enumerate(ag_in)]]
    root = n - 1
    b_in = _e7_tensors(torch, attn, dev, args.seed + 2, r, "bf16")
    b_want = _e7_tensors(torch, attn, dev, args.seed + 2, root, "bf16")
    c2 = legs()
    b_hier = [hvd.broadcast(t, root_rank=root, name=f"e7.b.h.{i}")
              for i, t in enumerate(b_in)]
    c3 = legs()
    b_flat = [eager._engine().synchronize(eager._engine().enqueue(
        f"e7.b.f.{i}", eager.CollectiveType.BROADCAST, t.clone(),
        root_rank=root, hierarchical=False)) for i, t in enumerate(b_in)]
    torch.cuda.synchronize()
    res["allgather"] = dict(
        same=all(torch.equal(a, b) for a, b in zip(hier, flat)),
        right=all(torch.equal(a, b) for a, b in zip(hier, want)),
        legs=[b - a for a, b in zip(c0, c1)][3:6])
    res["broadcast"] = dict(
        root=root,
        same=all(torch.equal(a, b) for a, b in zip(b_hier, b_flat)),
        right=all(torch.equal(a, b) for a, b in zip(b_hier, b_want)),
        legs=[b - a for a, b in zip(c2, c3)][6:9])
    del ag_in, want, hier, flat, b_in, b_want, b_hier, b_flat
    progress("(b) allgather and broadcast done")
    # (c) Adasum of a float32 gradient set: two-level, flat VHD, the tree.
    attn = _layer_shapes(cfg, attention_only=True)
    x = _e7_tensors(torch, attn, dev, args.seed + 3, r, "f32")
    ref = _adasum64(torch, [torch.cat([t.reshape(-1).double() for t in ts])
                            for ts in (_e7_tensors(torch, attn, dev,
                                                   args.seed + 3, q, "f32")
                                       for q in range(n))])

    def close(out, want_):
        got = torch.cat([t.reshape(-1).double() for t in out])
        err = (got - want_).abs()
        return (bool((err <= ADASUM_ATOL + ADASUM_RTOL * want_.abs()).all()),
                float(err.max()))
    c0 = legs()
    t0 = time.perf_counter()
    a_hier = eager.grouped_allreduce(x, name="e7.a.h", op=hvd.Adasum)
    torch.cuda.synchronize()
    ah_s = time.perf_counter() - t0
    c1 = legs()
    t0 = time.perf_counter()
    a_flat = eager.grouped_allreduce(x, name="e7.a.f", op=hvd.Adasum,
                                     hierarchical=False)
    torch.cuda.synchronize()
    af_s = time.perf_counter() - t0
    within, err = close(a_hier, ref)
    res["adasum"] = dict(
        same=all(torch.equal(a, b) for a, b in zip(a_hier, a_flat)),
        within=within, max_err=err, legs=[b - a for a, b in zip(c0, c1)][:3],
        hier_s=ah_s, flat_s=af_s, bits=_checksum(torch, enumerate(a_hier)),
        nbytes=_nbytes(x))
    del a_hier, a_flat, ref
    ps = hvd.add_process_set(list(range(3)))
    if r < 3:
        ref3 = _adasum64(torch, [
            torch.cat([t.reshape(-1).double() for t in _e7_tensors(
                torch, attn, dev, args.seed + 3, q, "f32")])
            for q in range(3)])
        a3 = eager.grouped_allreduce(x, name="e7.a.3", op=hvd.Adasum,
                                     process_set=ps)
        within3, err3 = close(a3, ref3)
        res["adasum3"] = dict(within=within3, max_err=err3,
                              bits=_checksum(torch, enumerate(a3)))
        del a3, ref3
    hvd.remove_process_set(ps)
    del x
    torch.cuda.empty_cache()
    progress("(c) Adasum done")
    # (d) DistributedOptimizer(SGD, op=Adasum) training Llama.
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1 + 1000 * r))
    named = list(tl.named_parameters(params))
    sums_before = _checksum(torch, named)
    c0 = legs()
    hvd.broadcast_parameters(params, root_rank=0)
    torch.cuda.synchronize()
    res["bcast_legs"] = [b - a for a, b in zip(c0, legs())][6:9]
    res["sums_before"], res["sums_bcast"] = sums_before, _checksum(torch,
                                                                   named)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=E7_LR),
        named_parameters=named, op=hvd.Adasum)
    step = tl.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    xb, yb = toks[:, :-1], toks[:, 1:]
    _zero_flash(fa)
    ak.dots.launches = ak.combine.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(E7_STEPS):
        c0 = [eng.pipeline_dispatches, eng.fused_groups] + legs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, xb, yb).item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = [b - a for a, b in zip(c0, [eng.pipeline_dispatches,
                                        eng.fused_groups] + legs())]
        steps.append(dict(loss=loss, s=dt, batches=d[0], groups=d[1],
                          hier=d[2:5], sums=_checksum(torch, named)))
        progress(f"(d) step {len(steps)} done")
    res["train"] = dict(
        layers=cfg.n_layers, steps=steps, flash=_flash_counts(fa),
        dots=ak.dots.launches, combine=ak.combine.launches,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        leaves=len(named), grad_bytes=_nbytes([t for _, t in named]))
    hvd.shutdown()
    faulthandler.cancel_dump_traceback_later()
    stacks.close()
    _write_result(args.e7_worker, res)
    print(f"e7 rank {r}: done", flush=True)
    return 0


def e7_phase(torch, layers, seed, card, timeout_s=E7_TIMEOUT_S):
    """E7: four ranks through the port's launcher with the hierarchical
    flags (``e7_worker``).  Every result bitwise equal across the ranks
    and the two-level ones to flat; Adasum within ADASUM_RTOL/ADASUM_ATOL
    of the float64 tree; the training's parameters bitwise equal across
    ranks after every step, finite losses, the flash launches (each kernel
    once a layer and step) and the Adasum launches (the VHD's rounds x the
    steps' dtype groups).  Returns ``(ok, counts)``."""
    import numpy as np
    results, route, wall = launch_ranks(
        torch, "--e7-worker", layers, seed, timeout_s, E7_RANKS,
        E7_HIER_FLAGS, {"HOROVOD_HIERARCHICAL_LOCAL_SIZE": str(E7_LOCAL)})
    if results is None:
        return False, None
    a = results[0]
    ok = all(x["slices"] == [E7_RANKS // E7_LOCAL, E7_LOCAL] and x["groups"]
             for x in results)
    print(f"e7: {E7_RANKS} ranks ({route}) in {wall:.1f} s; slices "
          f"{a['slices'][0] if a['slices'] else 0} x "
          f"{a['slices'][1] if a['slices'] else 0} from "
          f"HOROVOD_HIERARCHICAL_LOCAL_SIZE={E7_LOCAL}, the local and cross "
          f"groups made on every rank: {ok}", flush=True)
    for op, x in a["allreduce"].items():
        across = all(y["allreduce"][op]["bits"] == x["bits"]
                     for y in results)
        good = (across and all(y["allreduce"][op]["same"]
                               and y["allreduce"][op]["right"]
                               for y in results)
                and x["legs"] == [1, 2, 1] and x["flat_legs"] == [0, 0, 0])
        ok = ok and good
        print(f"e7[a, {op}]: the integer-valued bf16 layer gradient set "
              f"({a['set_bytes'] / 2**20:.0f} MiB a rank) two-level "
              f"bitwise the flat submission: {x['same']}, the exact "
              f"result: {x['right']}, the same on every rank: {across}; "
              f"dispatches/local/cross legs {x['legs']} (flat "
              f"{x['flat_legs']}); {x['hier_s'] * 1e3:.1f} ms two-level, "
              f"{x['flat_s'] * 1e3:.1f} ms flat on rank 0 -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    for kind, want in (("allgather", [1, 1, 1]), ("broadcast", [2, 2, 2])):
        good = all(y[kind]["same"] and y[kind]["right"] for y in results) \
            and a[kind]["legs"] == want
        ok = ok and good
        root = (f" (root {a[kind]['root']}, in the other slice)"
                if kind == "broadcast" else "")
        print(f"e7[b, {kind}]: two-level bitwise flat and the expected "
              f"bytes on every rank: {good}{root}; dispatches/local/cross "
              f"legs {a[kind]['legs']} -> {'PASS' if good else 'FAIL'}",
              flush=True)
    x = a["adasum"]
    across = all(y["adasum"]["bits"] == x["bits"] for y in results)
    good = (across and all(y["adasum"]["same"] and y["adasum"]["within"]
                           for y in results) and x["legs"] == [1, 2, 1])
    ok = ok and good
    print(f"e7[c]: Adasum of a float32 attention gradient set "
          f"({x['nbytes'] / 2**20:.0f} MiB a rank): two-level bitwise the "
          f"flat VHD: {x['same']}, the same on every rank: {across}, within "
          f"rtol {ADASUM_RTOL:g} atol {ADASUM_ATOL:g} of the float64 tree: "
          f"{x['within']} (max error {x['max_err']:.2e}); legs "
          f"{x['legs']}; {x['hier_s'] * 1e3:.1f} ms two-level, "
          f"{x['flat_s'] * 1e3:.1f} ms flat -> {'PASS' if good else 'FAIL'}",
          flush=True)
    three = [y["adasum3"] for y in results[:3]]
    good = all(t["within"] for t in three) and all(
        t["bits"] == three[0]["bits"] for t in three)
    ok = ok and good
    print(f"e7[c]: Adasum on a process set of 3 ranks (the tree): within "
          f"the tolerance of the float64 tree on each: "
          f"{[t['within'] for t in three]} (max error "
          f"{max(t['max_err'] for t in three):.2e}), the same on the three: "
          f"{all(t['bits'] == three[0]['bits'] for t in three)} -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    bc = (len({str(y["sums_before"]) for y in results}) == E7_RANKS
          and all(y["sums_bcast"] == a["sums_bcast"] for y in results)
          and a["bcast_legs"][0] > 0)
    ok = ok and bc
    t = a["train"]
    print(f"e7[d]: Llama at full width, {t['layers']} layers (of 32; "
          f"{E7_LAYERS} keep four ranks on one card within a few minutes "
          f"over NCCL's sockets), {t['leaves']} leaves ({t['grad_bytes'] / 2**30:.2f} "
          f"GiB of bf16 gradients a rank): rank 0's weights on every rank "
          f"after broadcast_parameters ({a['bcast_legs'][0]} two-level "
          f"broadcasts): {bc}", flush=True)
    rounds = (E7_RANKS).bit_length() - 1
    for i in range(E7_STEPS):
        ss = [y["train"]["steps"][i] for y in results]
        same = all(s["sums"] == ss[0]["sums"] for s in ss)
        finite = bool(np.isfinite([s["loss"] for s in ss]).all())
        hier = all(s["hier"] == [s["batches"], 2 * s["batches"],
                                 s["batches"]] for s in ss)
        good = same and finite and hier
        ok = ok and good
        losses = " / ".join(f"{s['loss']:.5f}" for s in ss)
        print(f"e7[d] step {i + 1}: losses {losses}; parameters "
              f"bitwise equal across the {E7_RANKS} ranks: {same}; "
              f"{ss[0]['batches']} batches, {ss[0]['groups']} dtype "
              f"groups, all two-level: {hier}; step {ss[0]['s']:.2f} s on "
              f"rank 0 -> {'PASS' if good else 'FAIL'}", flush=True)
    groups = sum(s["groups"] for s in t["steps"])
    want_flash = [t["layers"] * E7_STEPS] * 3
    launch_ok = (t["flash"] == want_flash
                 and t["dots"] == t["combine"] == rounds * groups > 0
                 and all(y["train"]["dots"] == t["dots"] for y in results))
    ok = ok and launch_ok
    med = sorted(s["s"] for s in t["steps"])[len(t["steps"]) // 2]
    print(f"e7[d]: flash launches fwd/dq/dkv {t['flash']} (= {want_flash} "
          f"expected); Adasum launches dots {t['dots']}, combine "
          f"{t['combine']} (= {rounds} rounds x {groups} dtype groups "
          f"expected); median step {med:.2f} s, peak memory "
          f"{t['peak_gib']:.2f} GiB on rank 0 [{card}; {route}] -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return ok, dict(dots=t["dots"], combine=t["combine"], step_s=med)


# ---------------------------------------------------------- observability
E8_LAYERS = 1             # one layer keeps the whole script in its limit
E8_STEPS = 3
E8_TIMEOUT_S = 300
E8_PHASE_TOL = 0.05      # phase_sum_us within 5 % of cycle_us
E8_FLAGS = ("--timeline-filename", "{tmp}/tl", "--timeline-mark-cycles",
            "--trace-filename", "{tmp}/tr", "--monitor", "--monitor-port",
            "{port}", "--monitor-interval", "1")
E8_LANES = ("QUEUE", "NEGOTIATE_ALLREDUCE", "NCCL_ALLREDUCE")
# The pack's kernels in a Chrome trace (fusion.cu: what hvd_fusion_pack
# and hvd_fusion_copy launch, kPack = true), and NCCL's.
E8_PACK_KERNEL = re.compile(r"walk_kernel<.*, true>|bulk_kernel<true>")
E8_NCCL_KERNEL = re.compile(r"nccl", re.I)
E8_PROBES = ("nccl_built", "gloo_enabled", "mpi_enabled",
             "mpi_threads_supported", "cuda_built", "rocm_built")


def _scrape(port, running, out):
    """Rank 0's monitor port while ``running`` is set: the first answers
    of ``/metrics``, ``/health`` and ``/snapshot`` that came back while it
    still was."""
    import urllib.request
    base = f"http://127.0.0.1:{port}"
    while running.is_set() and "snapshot" not in out:
        try:
            got = {p: urllib.request.urlopen(base + p, timeout=10).read()
                   for p in ("/metrics", "/health", "/snapshot")}
        except OSError as exc:
            out.setdefault("errors", []).append(str(exc))
            time.sleep(0.2)
            continue
        if not running.is_set():
            return
        m = re.search(r'^hvd_cycles_total\{rank="0"\} (\S+)$',
                      got["/metrics"].decode(), re.M)
        out["cycles_total"] = float(m.group(1)) if m else None
        out["health"] = json.loads(got["/health"])["status"]
        out["snapshot"] = sorted(json.loads(got["/snapshot"])["table"])


def e8_worker(args):
    """One rank of E8, started by ``e8_phase`` through the port's launcher
    with the timeline, tracer and monitor armed (``E8_FLAGS``): init ->
    broadcast_parameters from rank 0 -> DistributedOptimizer(SGD) ->
    ``E8_STEPS`` steps of Llama at full width on this rank's own batch,
    the launch counts zeroed just before and read just after.  Rank 0
    scrapes its monitor port while step 2 runs and profiles step 3 with
    ``hvd.profile_step``.  Writes ``rank<HOROVOD_RANK>.json`` in
    ``args.e8_worker``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    st = basics._get_state()
    eng, ctl = st.engine, st.controller
    res = dict(rank=r, card=torch.cuda.get_device_name(dev),
               tracer=eng.tracer is not None, monitor=st.monitor is not None,
               queries=dict(cross_rank=hvd.cross_rank(),
                            cross_size=hvd.cross_size(),
                            is_homogeneous=hvd.is_homogeneous(),
                            **{p: getattr(hvd, p)() for p in E8_PROBES}))
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1 + 1000 * r))
    named = list(tl.named_parameters(params))
    hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
        named_parameters=named)
    step = tl.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    prof_dir = os.path.join(args.e8_worker, "profile")

    def counters():
        return [eng.reduce_pack_us_total, eng.reduce_collective_us_total,
                eng.reduce_unpack_us_total, eng.timed_batches,
                eng.pipeline_dispatches, eng.fused_groups,
                fusion.pack.launches, fusion.unpack.launches]

    _zero_flash(fa)
    fusion.pack.launches = fusion.unpack.launches = 0
    steps, scraped = [], {}
    for i in range(E8_STEPS):
        running = threading.Event()
        poll = None
        if i == 1 and r == 0:
            running.set()
            poll = threading.Thread(target=_scrape, args=(
                int(os.environ["HOROVOD_MONITOR_PORT"]), running, scraped))
        prof = (hvd.profile_step(prof_dir) if i == 2 and r == 0
                else contextlib.nullcontext())
        c0 = counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if poll is not None:
            poll.start()
        with prof:
            loss = step(params, x, y).item()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        running.clear()
        if poll is not None:
            poll.join(timeout=30)
        d = [b - a for a, b in zip(c0, counters())]
        steps.append(dict(loss=loss, s=dt, pack_us=d[0], coll_us=d[1],
                          unpack_us=d[2], timed=d[3], batches=d[4],
                          groups=d[5], pack=d[6], unpack=d[7],
                          profiled=i == 2 and r == 0,
                          sums=_checksum(torch, named)))
    res.update(steps=steps, scraped=scraped, flash=_flash_counts(fa),
               pack=fusion.pack.launches, unpack=fusion.unpack.launches,
               summary=eng.tracer.phase_summary(), leaves=len(named),
               grad_bytes=_nbytes([t for _, t in named]),
               monitor_bytes=ctl.monitor_bytes_sent,
               frames=st.monitor.frames_sent)
    hvd.shutdown()
    _write_result(args.e8_worker, res)
    print(f"e8 rank {r}: done", flush=True)
    return 0


def _lanes(path):
    """A timeline's activities by tensor: name -> the B events' names in
    order; and its cycle marks."""
    with open(path) as fh:
        events = json.load(fh)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    lanes = {}
    for e in events:
        if e.get("ph") == "B":
            lanes.setdefault(names[e["tid"]], []).append(e["name"])
    marks = sum(1 for e in events if e["name"] == "CYCLE_START")
    return lanes, marks


def _e8_files(tmp, np_):
    """E8's files, read before the result directory goes: each rank's
    timeline, the two trace files merged by ``python -m
    horovod_tpu_torch.trace`` (with its report), and rank 0's profile."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = dict(timelines=[])
    for r in range(np_):
        lanes, marks = _lanes(os.path.join(tmp, f"tl.{r}"))
        grads = {n: [a for a in acts if a in E8_LANES]
                 for n, acts in lanes.items() if n.startswith("allreduce.")}
        out["timelines"].append(dict(
            lanes=len(lanes), grads=len(grads), marks=marks,
            ordered=sorted({len(a) // 3 for a in grads.values()
                            if a == list(E8_LANES) * (len(a) // 3)}),
            misordered=[n for n, a in grads.items()
                        if a != list(E8_LANES) * (len(a) // 3)
                        or not a][:4]))
    merged = os.path.join(tmp, "merged.json")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.trace",
         os.path.join(tmp, "tr"), "--report", "-o", merged],
        cwd=here, capture_output=True, text=True, timeout=120)
    out["merge_s"] = time.perf_counter() - t0
    out["merge_rc"] = run.returncode
    out["report"] = run.stdout[-3000:] + run.stderr[-1000:]
    if run.returncode == 0:
        with open(merged) as fh:
            ev = json.load(fh)["traceEvents"]
        out["rank_lanes"] = len({e["pid"] for e in ev
                                 if e.get("name") == "process_name"})
        out["flows"] = sum(1 for e in ev if e.get("ph") in ("s", "t", "f"))
    kernels = []
    for path in glob.glob(os.path.join(tmp, "profile", "*.json")):
        with open(path) as fh:
            kernels += [e["name"] for e in json.load(fh)["traceEvents"]
                        if e.get("cat") == "kernel"]
    out["profile_kernels"] = len(kernels)
    out["profile_pack"] = sorted({k[:90] for k in kernels
                                  if E8_PACK_KERNEL.search(k)})[:3]
    out["profile_nccl"] = sorted({k[:90] for k in kernels
                                  if E8_NCCL_KERNEL.search(k)})[:3]
    return out


def e8_phase(torch, layers, seed, card, timeout_s=E8_TIMEOUT_S):
    """E8: two ranks through the port's launcher with the timeline, the
    tracer and the monitor armed (``e8_worker``), and its nine checks:
    (1) each rank's timeline parses, every gradient goes QUEUE ->
    NEGOTIATE_ALLREDUCE -> NCCL_ALLREDUCE once a step, with cycle marks;
    (2) the trace files merge into one perfetto file with two rank lanes
    and cycle flows, and the report names a phase; (3) rank 0's reduce
    phase is nonzero and its phase sum within E8_PHASE_TOL of its mean
    lifecycle; (4) each step's CUDA-event pack + collective + unpack time
    is above zero and within the step's wall time; (5) rank 0's monitor
    port answered ``/metrics``, ``/health`` and ``/snapshot`` during step
    2 with cycles counted and both ranks in the table; (6) rank 0's
    profile names the pack's kernel and an NCCL kernel; (7) pack and
    unpack launches = the steps' dtype groups; (8) parameters bitwise
    equal across the ranks after every step; (9) the runtime's queries.
    Returns ``(ok, counts)``."""
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.common.net import free_ports
    port, = free_ports(1)
    flags = [f.replace("{port}", str(port)) for f in E8_FLAGS]
    results, route, wall = launch_ranks(
        torch, "--e8-worker", layers, seed, timeout_s, 2, flags,
        inspect=lambda tmp: _e8_files(tmp, 2))
    if results is None:
        return False, None
    *ranks, files = results
    a = ranks[0]
    ok = all(x["tracer"] and x["monitor"] for x in ranks)
    print(f"e8: 2 ranks ({route}) in {wall:.1f} s with "
          f"{' '.join(E8_FLAGS[:-5])} --monitor --monitor-port {port} "
          f"--monitor-interval 1; tracer and monitor armed on both: {ok}",
          flush=True)
    # (9) the runtime's queries.
    q = [x["queries"] for x in ranks]
    good = (all(x["cross_size"] == 2 and x["is_homogeneous"]
                and x["nccl_built"] and x["cuda_built"] for x in q)
            and sorted(x["cross_rank"] for x in q) == [0, 1])
    ok = ok and good
    for r, x in enumerate(q):
        print(f"e8[9] rank {r}: " + ", ".join(f"{k} {v}" for k, v in
                                             x.items())
              + f" -> {'PASS' if good else 'FAIL'}", flush=True)
    # (7), (8), (4): the steps.
    for i in range(E8_STEPS):
        ss = [x["steps"][i] for x in ranks]
        same = all(s["sums"] == ss[0]["sums"] for s in ss)
        finite = bool(np.isfinite([s["loss"] for s in ss]).all())
        launches = all(s["pack"] == s["unpack"] == s["groups"] > 0
                       for s in ss)
        red = [(s["pack_us"] + s["coll_us"] + s["unpack_us"]) / 1e6
               for s in ss]
        timed = all(0 < t <= s["s"] and s["timed"] == s["batches"]
                    for t, s in zip(red, ss))
        good = same and finite and launches and timed
        ok = ok and good
        s = ss[0]
        losses = " / ".join(f"{t['loss']:.5f}" for t in ss)
        note = " (profiled on rank 0)" if s["profiled"] else ""
        print(f"e8 step {i + 1}{note}: losses {losses}; "
              f"parameters bitwise equal across ranks: {same}; "
              f"{s['batches']} batches, {s['groups']} dtype groups, "
              f"pack/unpack launches {s['pack']}/{s['unpack']} (= dtype "
              f"groups: {launches}); step {s['s'] * 1e3:.1f} ms armed on "
              f"rank 0, of it on the card pack {s['pack_us'] / 1e3:.2f} ms, "
              f"NCCL {s['coll_us'] / 1e3:.2f} ms, unpack "
              f"{s['unpack_us'] / 1e3:.2f} ms (CUDA events, "
              f"{s['timed']} batches timed; within the step on both ranks: "
              f"{timed}) -> {'PASS' if good else 'FAIL'}", flush=True)
    # (3) rank 0's phases.
    sm = a["summary"]
    ph = sm["phases_us"] or {}
    good = (bool(ph) and ph.get("reduce", 0) > 0 and abs(
        sm["phase_sum_us"] - sm["cycle_us"]) <= E8_PHASE_TOL * sm["cycle_us"])
    ok = ok and good
    print(f"e8[3]: rank 0's {sm['spans']} spans, mean us: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ph.items())
          + f"; phase sum {sm['phase_sum_us']} us against the mean "
          f"lifecycle {sm['cycle_us']} us (within {E8_PHASE_TOL:.0%}) "
          f"-> {'PASS' if good else 'FAIL'}", flush=True)
    # (1) the timelines.
    good = True
    for r, t in enumerate(files["timelines"]):
        g = (t["grads"] == a["leaves"] and t["marks"] > 0
             and t["ordered"] == [E8_STEPS] and not t["misordered"])
        good = good and g
        print(f"e8[1] rank {r}: timeline parses, {t['lanes']} lanes, "
              f"{t['grads']} gradients (of {a['leaves']} leaves) each "
              f"{' -> '.join(E8_LANES)} x {t['ordered']} (steps "
              f"{E8_STEPS}), out of order {t['misordered']}, "
              f"{t['marks']} cycle marks -> {'PASS' if g else 'FAIL'}",
              flush=True)
    ok = ok and good
    # (2) the merged trace.
    rep = files["report"]
    good = (files["merge_rc"] == 0 and files.get("rank_lanes") == 2
            and files.get("flows", 0) > 0
            and any(p in rep for p in ("queue", "negotiation", "reduce")))
    ok = ok and good
    print(f"e8[2]: python -m horovod_tpu_torch.trace merged both ranks' "
          f"files in {files['merge_s']:.1f} s (rc {files['merge_rc']}): "
          f"{files.get('rank_lanes')} rank lanes, {files.get('flows')} "
          f"flow points; report:\n{rep.strip()[:1500]}\n"
          f"e8[2] -> {'PASS' if good else 'FAIL'}", flush=True)
    # (5) the monitor.
    sc = a["scraped"]
    good = ((sc.get("cycles_total") or 0) > 0 and sc.get("snapshot")
            == ["0", "1"] and sc.get("health") is not None)
    ok = ok and good
    print(f"e8[5]: rank 0's monitor during step 2: hvd_cycles_total "
          f"{sc.get('cycles_total')}, /health {sc.get('health')}, "
          f"/snapshot ranks {sc.get('snapshot')}, errors "
          f"{sc.get('errors', [])[:2]}; frames sent {a['frames']}, "
          f"monitor frame bytes {a['monitor_bytes']} on rank 0 -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    # (6) the profile.
    good = bool(files["profile_pack"]) and bool(files["profile_nccl"])
    ok = ok and good
    print(f"e8[6]: rank 0's hvd.profile_step trace of step 3: "
          f"{files['profile_kernels']} kernel events; the pack's kernel "
          f"{files['profile_pack'][:1]}, NCCL {files['profile_nccl'][:1]} "
          f"-> {'PASS' if good else 'FAIL'}", flush=True)
    steps = a["steps"]
    med = sorted(s["s"] for s in steps)[len(steps) // 2]
    print(f"e8: Llama at full width, {layers} layers, {a['leaves']} leaves "
          f"({a['grad_bytes'] / 2**30:.2f} GiB of bf16 gradients a rank); "
          f"median step {med:.3f} s armed [{card}; {route}: NCCL's socket "
          f"transport, not NVLink] -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    return ok, dict(pack=a["pack"], unpack=a["unpack"], flash=a["flash"],
                    step_s=med)


# ------------------------------------------------------------ E9: ZeRO
E9_LAYERS = 2
E9_STEPS = 3
E9_LR = 1e-3             # AdamW, state in the parameters' bf16
E9_CHUNK = 256 << 20     # HOROVOD_PIPELINE_CHUNK: 6 buckets of <= 256 MiB
E9_TIMEOUT_S = 420
E9_BYTES_TOL = 0.55      # ZeRO-1 state / replicated; FSDP memory / ZeRO-1
E9_MODES = ((False, "replicated"), (None, "zero1"), ("full", "fsdp"))


def _wait_timed(eng, timeout_s=30.0):
    """Until the engine has read every dispatched batch's reduce-phase
    marks (the in-flight watcher reads them after the card is done)."""
    t0 = time.time()
    while eng.timed_batches < eng.pipeline_dispatches \
            and time.time() - t0 < timeout_s:
        time.sleep(0.005)


def e9_worker(args):
    """One rank of E9, started by ``e9_phase`` through the port's launcher
    with ``--sharded`` (``HOROVOD_SHARDED_OPTIMIZER=1``), ``HOROVOD_TRACE=1``
    and ``HOROVOD_PIPELINE_CHUNK``: Llama at full width, ``E9_STEPS`` steps
    of ``DistributedOptimizer(AdamW)`` in three modes one after another,
    each from the same seeded parameters on the same token streams:
    replicated (``sharded=False``), ZeRO-1 (``sharded=None``: the
    launcher's flag), FSDP (``sharded="full"``, whose gathers are timed
    apart from the step).  Then the FSDP saveable loaded into a new
    optimizer.  Writes ``rank<HOROVOD_RANK>.json`` in ``args.e9_worker``."""
    import gc
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.trace import TraceRecorder
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    eng = basics._get_state().engine
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (E9_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)

    def counters():
        return [eng.reduce_pack_us_total + eng.reduce_collective_us_total
                + eng.reduce_unpack_us_total, eng.reduce_collective_us_total,
                eng.pipeline_dispatches, fusion.pack.launches,
                fusion.unpack.launches]

    def fresh(seed):
        params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed))
        return params, list(tl.named_parameters(params))

    res = dict(rank=r, card=torch.cuda.get_device_name(dev),
               tracer=eng.tracer is not None, modes={})
    for sharded, label in E9_MODES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        params, named = fresh(args.seed + 1)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW([t for _, t in named], lr=E9_LR),
            named_parameters=named, sharded=sharded)
        step = tl.make_train_step(cfg, opt)
        eng.tracer = TraceRecorder()
        _zero_flash(fa)
        fusion.pack.launches = fusion.unpack.launches = 0
        o0 = eng.prefetch_overlapped
        k0, g0 = eng.pipeline_chunks_total, eng.fused_groups
        steps = []
        for i in range(E9_STEPS):
            x, y = toks[i, :, :-1], toks[i, :, 1:]
            torch.cuda.synchronize()
            _wait_timed(eng)
            c0 = counters()
            t0 = time.perf_counter()
            gather_s, cg = 0.0, c0
            if label == "fsdp" and i > 0:
                # The gathers apart (make_train_step's gather_params then
                # finds the parameters in memory and slices nothing new).
                opt.gather_params()
                torch.cuda.synchronize()
                gather_s = time.perf_counter() - t0
                _wait_timed(eng)
                cg = counters()
            loss = step(params, x, y).item()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            _wait_timed(eng)
            c1 = counters()
            steps.append(dict(
                loss=loss, s=dt, gather_s=gather_s,
                gather_us=cg[0] - c0[0], gather_nccl_us=cg[1] - c0[1],
                step_us=c1[0] - cg[0], step_nccl_us=c1[1] - cg[1],
                batches=c1[2] - c0[2], pack=c1[3] - c0[3],
                unpack=c1[4] - c0[4],
                allocated=torch.cuda.memory_allocated(dev)))
        if label == "fsdp":
            opt.gather_params()
        torch.cuda.synchronize()
        m = dict(steps=steps, sums=_checksum(torch, named),
                 flash=_flash_counts(fa), pack=fusion.pack.launches,
                 unpack=fusion.unpack.launches,
                 chunks=eng.pipeline_chunks_total - k0,
                 groups=eng.fused_groups - g0,
                 summary=eng.tracer.phase_summary(),
                 peak=torch.cuda.max_memory_allocated(dev),
                 overlapped=eng.prefetch_overlapped - o0,
                 sharded=getattr(opt, "sharded", False), base=base,
                 params_bytes=_nbytes([t for _, t in named]))
        if sharded is False:
            m["state"] = sum(v.numel() * v.element_size()
                             for st in opt.state.values()
                             for v in st.values()
                             if isinstance(v, torch.Tensor))
        else:
            m["state"] = opt.opt_state_bytes()
            m["buckets"] = len(opt._plan.buckets)
            m["shards_on"] = sorted({str(s.device) for s in opt._shards})
        if label == "fsdp":
            t0 = time.perf_counter()
            saved = opt.hvd_sharded_saveable()
            _, named2 = fresh(args.seed + 7)
            opt2 = hvd.DistributedOptimizer(
                torch.optim.AdamW([t for _, t in named2], lr=E9_LR),
                named_parameters=named2, sharded="full")
            loaded = opt2.load_sharded_saveable(saved)
            same = loaded and all(
                torch.equal(a, b) for a, b in zip(opt._shards, opt2._shards))
            for o1, o2 in zip(opt._inner, opt2._inner):
                for p1, p2 in zip(o1.param_groups[0]["params"],
                                  o2.param_groups[0]["params"]):
                    s1, s2 = o1.state[p1], o2.state[p2]
                    same = same and sorted(s1) == sorted(s2) and all(
                        torch.equal(s1[k], s2[k].to(s1[k].device))
                        for k in s1)
            m.update(saveable=same, saveable_s=time.perf_counter() - t0,
                     saveable_gb=sum(_nbytes([t for t in b])
                                     for b in saved["param_shards"]) / 1e9)
            del saved, opt2, named2
        res["modes"][label] = m
        del opt, step, params, named
        # The replicated optimizer's hooks and its parameters refer to each
        # other: only the cycle collector frees them before the next mode.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    hvd.shutdown()
    _write_result(args.e9_worker, res)
    print(f"e9 rank {r}: done", flush=True)
    return 0


def e9_phase(torch, layers, seed, card, timeout_s=E9_TIMEOUT_S):
    """E9: two ranks through the port's launcher with ``--sharded``
    (``e9_worker``), and its checks: (1) the parameters' checksums after
    the steps equal across the replicated, ZeRO-1 and FSDP modes and
    across the ranks, every loss finite; (2) ZeRO-1's optimizer state at
    most E9_BYTES_TOL of the replicated optimizer's; (3) FSDP's
    ``memory_allocated`` between steps at most E9_BYTES_TOL of ZeRO-1's;
    (4) ``prefetch_overlapped >= 1`` with at least 4 buckets; (5) the FSDP
    saveable loads bitwise into a new optimizer; (6) ZeRO-1 came from the
    launcher's flag, its shards on the card; pack = unpack launches.
    Returns ``(ok, counts)`` (rank 0's launches over the three modes)."""
    import numpy as np
    results, route, wall = launch_ranks(
        torch, "--e9-worker", layers, seed, timeout_s, 2, ("--sharded",),
        env_extra={"HOROVOD_TRACE": "1",
                   "HOROVOD_PIPELINE_CHUNK": str(E9_CHUNK)})
    if results is None:
        return False, None
    a = results[0]
    ok = all(x["tracer"] for x in results)
    print(f"e9: 2 ranks ({route}) in {wall:.1f} s with --sharded, "
          f"HOROVOD_TRACE=1, HOROVOD_PIPELINE_CHUNK={E9_CHUNK}; tracer "
          f"armed on both: {ok}", flush=True)
    for _, label in E9_MODES:
        for x in results:
            m = x["modes"][label]
            med = sorted(s["s"] for s in m["steps"][1:])[
                (len(m["steps"]) - 1) // 2] if len(m["steps"]) > 1 else 0.0
            ph = (m["summary"]["phases_us"] or {})
            after = m["steps"][1:]
            n = max(1, len(after))
            coll = "allreduce" if label == "replicated" else (
                "reduce-scatter + allgather" if label == "zero1"
                else "reduce-scatter")
            gather = (f", allgather (gather_params) "
                      f"{sum(s['gather_us'] for s in after) / n / 1e3:.1f} "
                      f"ms on the card (NCCL "
                      f"{sum(s['gather_nccl_us'] for s in after) / n / 1e3:.1f}"
                      f"), {sum(s['gather_s'] for s in after) / n * 1e3:.1f} "
                      f"ms wall" if label == "fsdp" else "")
            print(f"e9 {label} rank {x['rank']}: losses "
                  + " / ".join(f"{s['loss']:.5f}" for s in m["steps"])
                  + f"; step after the first {med * 1e3:.1f} ms (median); "
                  f"{coll} {sum(s['step_us'] for s in after) / n / 1e3:.1f} "
                  f"ms a step on the card (pack + NCCL + unpack, CUDA "
                  f"events; NCCL "
                  f"{sum(s['step_nccl_us'] for s in after) / n / 1e3:.1f})"
                  f"{gather}; {m['steps'][-1]['batches']} batches; phases "
                  f"({m['summary']['spans']} spans, mean us) "
                  + ", ".join(f"{k} {v:.0f}" for k, v in ph.items())
                  + f"; optimizer state {m['state'] / 2**30:.3f} GiB, "
                  f"allocated between steps "
                  f"{m['steps'][-1]['allocated'] / 2**30:.3f} GiB (at the "
                  f"mode's start {m['base'] / 2**30:.3f}), peak "
                  f"{m['peak'] / 2**30:.2f} GiB a rank; launches flash "
                  f"{m['flash']}, pack/unpack {m['pack']}/{m['unpack']}"
                  + (f"; {m['buckets']} buckets, prefetch_overlapped "
                     f"{m['overlapped']}" if "buckets" in m else ""),
                  flush=True)
    # (1) the parameters.
    sums = {(x["rank"], label): x["modes"][label]["sums"]
            for x in results for _, label in E9_MODES}
    finite = all(np.isfinite(s["loss"]) for x in results
                 for m in x["modes"].values() for s in m["steps"])
    good = finite and len({tuple(v) for v in sums.values()}) == 1
    ok = ok and good
    print(f"e9[1]: parameter checksums after {E9_STEPS} steps "
          f"{sums[(0, 'replicated')]}, equal across the 3 modes and 2 ranks: "
          f"{len({tuple(v) for v in sums.values()}) == 1}; losses finite "
          f"{finite} -> {'PASS' if good else 'FAIL'}", flush=True)
    for x in results:
        rep, z1, fs = (x["modes"][k] for k in ("replicated", "zero1",
                                                 "fsdp"))
        # (2) ZeRO-1's state.
        ratio = z1["state"] / max(rep["state"], 1)
        good = ratio <= E9_BYTES_TOL
        ok = ok and good
        print(f"e9[2] rank {x['rank']}: optimizer state ZeRO-1 "
              f"{z1['state']} B / replicated {rep['state']} B = "
              f"{ratio:.4f} (<= {E9_BYTES_TOL}) -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        # (3) FSDP's memory between steps.
        mz, mf = z1["steps"][-1]["allocated"], fs["steps"][-1]["allocated"]
        good = mf <= E9_BYTES_TOL * mz
        ok = ok and good
        print(f"e9[3] rank {x['rank']}: memory_allocated between steps "
              f"FSDP {mf / 2**30:.3f} GiB / ZeRO-1 {mz / 2**30:.3f} GiB = "
              f"{mf / max(mz, 1):.4f} (<= {E9_BYTES_TOL}; replicated "
              f"{rep['steps'][-1]['allocated'] / 2**30:.3f} GiB) -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        # (4) the prefetch.
        good = fs["overlapped"] >= 1 and fs["buckets"] >= 4
        ok = ok and good
        print(f"e9[4] rank {x['rank']}: FSDP {fs['buckets']} buckets, "
              f"prefetch_overlapped {fs['overlapped']} -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        # (5) the saveable.
        good = fs["saveable"]
        ok = ok and good
        print(f"e9[5] rank {x['rank']}: FSDP saveable "
              f"({fs['saveable_gb']:.2f} GB of gathered parameter shards "
              f"and the gathered state) loaded bitwise into a new optimizer "
              f"in {fs['saveable_s']:.1f} s -> {'PASS' if good else 'FAIL'}",
              flush=True)
        # (6) the modes and launches: under HOROVOD_PIPELINE_CHUNK the
        # replicated mode's allreduces launch pack and unpack once a chunk
        # of their plan (pipeline_chunks_total), the sharded modes'
        # reduce-scatters and allgathers (no plan) once a dtype group.
        good = (rep["sharded"] is False and z1["sharded"] is True
                and fs["sharded"] == "full"
                and z1["shards_on"] == fs["shards_on"] == ["cuda:0"]
                and rep["pack"] == rep["unpack"] == rep["chunks"] > 0
                and all(m["pack"] == m["unpack"] == m["groups"] > 0
                        for m in (z1, fs)))
        ok = ok and good
        print(f"e9[6] rank {x['rank']}: modes {rep['sharded']} / "
              f"{z1['sharded']} (from --sharded) / {fs['sharded']!r}, shards "
              f"on {z1['shards_on']}; pack/unpack launches "
              f"{rep['pack']}/{rep['unpack']} replicated (= its chunk plans' "
              f"{rep['chunks']} chunks, {rep['groups']} dtype groups), "
              f"{z1['pack']}/{z1['unpack']} ZeRO-1 and {fs['pack']}/"
              f"{fs['unpack']} FSDP (= their {z1['groups']} and "
              f"{fs['groups']} dtype groups: not chunked) -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    print(f"e9: Llama at full width, {layers} layers "
          f"({a['modes']['replicated']['params_bytes'] / 2**30:.2f} GiB of "
          f"bf16 parameters a rank), AdamW, B={TRAIN_BATCH} T={TRAIN_SEQ} "
          f"[{card}; {route}: NCCL's socket transport, not NVLink] -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    modes = a["modes"].values()
    return ok, dict(pack=sum(m["pack"] for m in modes),
                    unpack=sum(m["unpack"] for m in modes),
                    flash=[sum(m["flash"][k] for m in modes)
                           for k in range(3)])


# ------------------------------------------------- E10: data-plane depth
E10_LAYERS = 1            # one layer keeps the whole script in its limit
E10_STEPS = 3
E10_TIMEOUT_S = 300
E10_MIB = 64             # the chunk and partition thresholds, MiB
E10_FAST_KB = 64         # the fast lane's threshold, KB
E10_FLAGS = ("--pipeline-chunk-mb", str(E10_MIB), "--fast-lane-threshold-kb",
             str(E10_FAST_KB), "--partition-threshold-mb", str(E10_MIB))
# (a)'s modes: label, chunk bytes, partition bytes, fast-lane bytes.
E10_MODES = (("off", 0, 0, 0), ("chunked", E10_MIB << 20, 0, 0),
             ("partitioned", 0, E10_MIB << 20, E10_FAST_KB << 10))
E10_RESNET_STEPS = 3
E10_BN_EXCHANGES = 106   # ResNet-50's batch-norm exchanges a step (2 x 53)
E10_CKPT_ITEMS = 8       # (d): checkpoint-lane items of 1 MiB each
E10_CKPT_BYTES = 1 << 20
E10_TUNE_LAYERS = 1      # (c): the autotuner over this Llama
# Enough steps for the search to end on both ranks: at 4 steps it ran 3 of
# its 4 evaluations, at 8 it ended within the fourth step after the first;
# 6 ran 3 of 4 on a machine whose steps made fewer cycles (PR 18), so 9.
E10_TUNE_STEPS = 9
E10_TUNE_ENV = {"HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HOROVOD_AUTOTUNE_MAX_EVALS": "4"}


def _e10_counters(eng, fusion):
    """The engine's data-plane counters and the fusion launches."""
    pp = eng._pingpong
    return dict(pack_us=eng.reduce_pack_us_total,
                coll_us=eng.reduce_collective_us_total,
                unpack_us=eng.reduce_unpack_us_total,
                overlap_us=eng.reduce_overlap_us_total,
                timed=eng.timed_batches, batches=eng.pipeline_dispatches,
                chunks=eng.pipeline_chunks_total, groups=eng.fused_groups,
                splits=eng.partition_splits,
                fast=eng.fast_lane_dispatches, hits=eng.fast_lane_hits,
                acquires=pp.acquires if pp is not None else 0,
                waits=pp.waits if pp is not None else 0,
                pack=fusion.pack.launches, unpack=fusion.unpack.launches)


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


def _busy_share(torch, fn):
    """``fn()``'s wall seconds and this process's kernel seconds inside
    it, from torch.profiler's CUDA activity (None where it records
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-6
    return wall, (busy if busy > 0 else None)


def e10_worker(args):
    """One rank of E10 (a), (b) and (d), started by ``e10_phase`` through
    the port's launcher with ``E10_FLAGS`` and ``HOROVOD_TRACE=1``.
    (a) Llama at full width, ``E10_STEPS`` steps of
    ``DistributedOptimizer(SGD)`` in each of ``E10_MODES`` from the same
    seeded parameters (the same on both ranks, no broadcast) on the same
    tokens; the knobs set between the modes, as the autotuner sets them.
    (b) ResNet-50 at size 2 (E6's configuration), the fast lane off then
    on, from the same seeded parameters; rank 0 profiles the last step of
    each.  (d) During step 2 of (b)'s fast mode, ``E10_CKPT_ITEMS``
    checkpoint-lane items that write a seeded payload.  Writes
    ``rank<HOROVOD_RANK>.json`` in ``args.e10_worker``."""
    import gc
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.scheduler import (CKPT_LANE, CheckpointChunk,
                                                 partition_plan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    r, dev, world = hvd.rank(), hvd.device(), hvd.size()
    eng = basics._get_state().engine
    res = dict(rank=r, card=torch.cuda.get_device_name(dev),
               tracer=eng.tracer is not None,
               knobs=[eng.pipeline_chunk_bytes, eng.partition_threshold,
                      eng.fast_lane_threshold])
    # (a) Llama, three modes.
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (E10_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    res["llama"] = {}
    for label, chunk, part, fast in E10_MODES:
        eng.pipeline_chunk_bytes = chunk
        eng.partition_threshold = part
        eng.fast_lane_threshold = fast
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = tl.init_params(cfg, torch.Generator(
            device=dev).manual_seed(args.seed + 1))
        named = list(tl.named_parameters(params))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
            named_parameters=named)
        step = tl.make_train_step(cfg, opt)
        _zero_flash(fa)
        _wait_timed(eng)
        c0 = _e10_counters(eng, fusion)
        steps = []
        for i in range(E10_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(params, toks[i, :, :-1], toks[i, :, 1:]).item()
            torch.cuda.synchronize()
            steps.append(dict(loss=loss, s=time.perf_counter() - t0))
        _wait_timed(eng)
        split = [n for n, t in named if part and t.numel()
                 * t.element_size() * world > part and len(partition_plan(
                     t.numel(), t.element_size(), part // world)) > 1]
        res["llama"][label] = dict(
            steps=steps, d=_delta(c0, _e10_counters(eng, fusion)),
            flash=_flash_counts(fa), sums=_checksum(torch, named),
            split=split, leaves=len(named),
            allocated=torch.cuda.memory_allocated(dev),
            peak=torch.cuda.max_memory_allocated(dev))
        del opt, step, params, named
    eng.pipeline_chunk_bytes = eng.partition_threshold = 0
    eng.fast_lane_threshold = 0
    del toks
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (b) ResNet-50 at size 2, the fast lane off and on; (d) in step 2 on.
    rcfg = tr.ResNetConfig()
    x, y = (torch.from_numpy(a).to(dev) for a in tr.synthetic_batch(
        RESNET_BATCH, 224, rcfg.num_classes, args.seed + 31 + r))
    payload = np.random.RandomState(args.seed + 50).randint(
        0, 256, E10_CKPT_ITEMS * E10_CKPT_BYTES).astype(np.uint8)
    ckpt_dir = os.path.join(args.e10_worker, f"ckpt{r}")
    os.makedirs(ckpt_dir, exist_ok=True)
    runs = []

    def item(i):
        def run():
            runs.append(dict(
                i=i, cycle=eng._cycle_index,
                grads_left=sum(1 for lane, *_ in eng._backlog
                               if lane != CKPT_LANE),
                on_cycle_thread=eng._cycle_owner == threading.get_ident()))
            with open(os.path.join(ckpt_dir, f"chunk{i}.bin"), "wb") as fh:
                fh.write(payload[i * E10_CKPT_BYTES:
                                 (i + 1) * E10_CKPT_BYTES].tobytes())
        return CheckpointChunk(f"ckpt.{i}", run)

    res["resnet"] = {}
    for label, fast in (("off", 0), ("fast", E10_FAST_KB << 10)):
        eng.fast_lane_threshold = fast
        params, stats = tr.init_params(rcfg, torch.Generator(
            device=dev).manual_seed(args.seed + 30))
        named = list(tr.named_parameters(params))
        step = tr.make_train_step(rcfg, _sgd(torch, hvd, named, RESNET_LR,
                                             0.9))
        state = {"stats": stats}

        def one():
            loss, state["stats"] = step(params, state["stats"], x, y)
            return float(loss)

        steps = []
        for i in range(E10_RESNET_STEPS):
            submitter = None
            if label == "fast" and i == 1:
                k0, d0 = eng.ckpt_chunks_dispatched, eng.pipeline_dispatches

                def submit():
                    t_end = time.time() + 30
                    while eng.pipeline_dispatches == d0 \
                            and time.time() < t_end:
                        time.sleep(0.0005)
                    eng.submit_checkpoint_io([item(j) for j in
                                              range(E10_CKPT_ITEMS)])

                submitter = threading.Thread(target=submit)
            c0 = _e10_counters(eng, fusion)
            ex0 = tr.cross_rank_moments.exchanges
            last = i == E10_RESNET_STEPS - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if submitter is not None:
                submitter.start()
            busy = None
            if last and r == 0:
                wall, busy = _busy_share(torch, one)
            else:
                one()
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if submitter is not None:
                submitter.join(timeout=60)
                t_end = time.time() + 30
                while eng.ckpt_chunks_dispatched - k0 < E10_CKPT_ITEMS \
                        and time.time() < t_end:
                    time.sleep(0.001)
                res["ckpt"] = dict(dispatched=eng.ckpt_chunks_dispatched - k0,
                                   budget=eng.ckpt_lane_budget, runs=runs)
            steps.append(dict(s=dt, busy=busy, profiled=last and r == 0,
                              bn=tr.cross_rank_moments.exchanges - ex0,
                              d=_delta(c0, _e10_counters(eng, fusion))))
        res["resnet"][label] = dict(
            steps=steps, sums=_checksum(torch, named),
            stats=_checksum(torch, list(tr.named_parameters(state["stats"]))))
        del params, state, named, step
    eng.fast_lane_threshold = 0
    files = []
    for i in range(E10_CKPT_ITEMS):
        path = os.path.join(ckpt_dir, f"chunk{i}.bin")
        with open(path, "rb") as fh:
            files.append(fh.read() == payload[
                i * E10_CKPT_BYTES:(i + 1) * E10_CKPT_BYTES].tobytes())
    res["ckpt"]["files"] = files
    hvd.shutdown()
    _write_result(args.e10_worker, res)
    print(f"e10 rank {r}: done", flush=True)
    return 0


def e10_tune_worker(args):
    """One rank of E10 (c), started through the port's launcher with
    ``--autotune`` and ``E10_TUNE_ENV``: ``E10_TUNE_STEPS`` steps of Llama
    at full width, ``args.train_layers`` deep, with every move the
    autotuner applies recorded with the lock-step round it landed at and
    the knobs after it.  Writes ``rank<HOROVOD_RANK>.json`` in
    ``args.e10_tune_worker``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import autotune
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r, dev = hvd.rank(), hvd.device()
    eng = basics._get_state().engine

    def knobs():
        ctl = eng.controller
        return [eng.fusion_threshold, eng.cycle_time_s, ctl.cache_capacity,
                eng.pipeline_chunk_bytes, eng.max_inflight,
                eng.fast_lane_threshold, ctl.round_pipeline]

    moves = []
    apply = autotune.ParameterManager._apply_params

    def recorded(self, params):
        apply(self, params)
        moves.append([eng.controller.rounds, knobs()])

    autotune.ParameterManager._apply_params = recorded
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1))
    named = list(tl.named_parameters(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in named], lr=TRAIN_LR),
        named_parameters=named)
    step = tl.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(args.seed + 2 + r).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int64)).to(dev)
    _zero_flash(fa)
    fusion.pack.launches = fusion.unpack.launches = 0
    steps = []
    for _ in range(E10_TUNE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(params, toks[:, :-1], toks[:, 1:]).item()
        torch.cuda.synchronize()
        steps.append(dict(loss=loss, s=time.perf_counter() - t0,
                          sums=_checksum(torch, named)))
    # Read once the cycle thread has stopped: a move lands at the end of
    # a cycle, which may still run after the step's waiters are released.
    hvd.shutdown()
    t = eng.autotuner
    res = dict(rank=r, steps=steps, moves=moves, final=knobs(),
               samples=t._sample_no, evals=t.search.evals,
               tuning=t.tuning, coords=len(t.search.point),
               flash=_flash_counts(fa), pack=fusion.pack.launches,
               unpack=fusion.unpack.launches)
    _write_result(args.e10_tune_worker, res)
    print(f"e10 (c) rank {r}: done", flush=True)
    return 0


def _e10_log(tmp):
    """The autotuner's log (both ranks append to the file the launcher
    names): (header, sample rows as floats, final lines)."""
    with open(os.path.join(tmp, "tune.csv")) as fh:
        lines = fh.read().strip().splitlines()
    header = lines[0].split(",")
    rows = [[float(v) for v in ln.split(",")] for ln in lines[1:]
            if not ln.startswith(("#", "sample,"))]
    return dict(header=header, rows=rows, widths=sorted({len(x)
                                                          for x in rows}),
                finals=[ln for ln in lines if ln.startswith("# final:")])


def e10_tune_phase(torch, seed, timeout_s=E10_TIMEOUT_S):
    """E10 (c) (``e10_tune_worker``, two ranks through the launcher with
    ``--autotune``): two samples or more, every applied move at the same
    round with the same knobs on both ranks, the search ended on both
    (all its evaluations, ``tuning`` off, the same final line from each
    rank in the log), the log parses, the parameters bitwise across the
    ranks every step.  Returns ``(ok, rank 0's result)``, the result None
    when a rank failed."""
    import numpy as np
    tuned, route_c, wall_c = launch_ranks(
        torch, "--e10-tune-worker", E10_TUNE_LAYERS, seed, timeout_s, 2,
        ("--autotune", "--autotune-log-file", "{tmp}/tune.csv"),
        env_extra=E10_TUNE_ENV, inspect=_e10_log)
    if tuned is None:
        return False, None
    ta, tb, log = tuned
    evals = int(E10_TUNE_ENV["HOROVOD_AUTOTUNE_MAX_EVALS"])
    ended = (not ta["tuning"] and not tb["tuning"]
             and ta["evals"] == tb["evals"] == evals
             and len(log["finals"]) == 2 and len(set(log["finals"])) == 1)
    good = (ta["samples"] == tb["samples"] >= 2
            and ta["moves"] == tb["moves"]
            and len(ta["moves"]) == ta["samples"]
            and ta["final"] == tb["final"]
            and ended
            and [s["sums"] for s in ta["steps"]]
            == [s["sums"] for s in tb["steps"]]
            and log["header"][:3] == ["sample", "fusion_threshold_bytes",
                                      "cycle_time_s"]
            and log["widths"] == [len(log["header"])]
            and len(log["rows"]) >= 2
            and all(np.isfinite(s["loss"]) for s in ta["steps"]))
    print(f"e10 (c): autotuner over Llama at full width, {E10_TUNE_LAYERS} "
          f"layer, {E10_TUNE_STEPS} steps, "
          + " ".join(f"{k}={v}" for k, v in E10_TUNE_ENV.items())
          + f" ({route_c}, {wall_c:.1f} s): {ta['coords']} coordinates, "
          f"{ta['samples']} / {tb['samples']} samples, {ta['evals']} / "
          f"{tb['evals']} evaluations of {evals}, tuning done on both "
          f"ranks {not ta['tuning'] and not tb['tuning']}; moves (round, "
          f"[fusion threshold, cycle s, cache capacity, chunk, in-flight, "
          f"fast lane, round pipeline]) {ta['moves']}, the same on both "
          f"ranks: {ta['moves'] == tb['moves']}; steps "
          + ", ".join(f"{s['s'] * 1e3:.0f}" for s in ta["steps"])
          + f" ms; parameters bitwise across the ranks every step: "
          f"{[s['sums'] for s in ta['steps']] == [s['sums'] for s in tb['steps']]}"
          f"; log header {log['header']}, {len(log['rows'])} sample rows of "
          f"widths {log['widths']}, final lines {log['finals'][:2]}, the "
          f"search ended on both ranks: {ended} -> "
          f"{'PASS' if good else 'FAIL'}", flush=True)
    return good, ta


def e10_phase(torch, layers, seed, card, timeout_s=E10_TIMEOUT_S):
    """E10: the data plane's depth on two ranks through the port's
    launcher.  (a) Llama at full width (``e10_worker``) in three modes:
    the parameters' checksums equal across the modes and the ranks; when
    chunked more chunks than batches; partitioned, the splits the
    tensors above the threshold give and fast-lane batches; ping-pong
    acquires in every mode; the flash launches 2 x ``layers`` x steps a
    mode.  (b) ResNet-50: parameters and statistics bitwise between the
    fast lane off and on; with it on, at least the 106 batch-norm
    exchanges a step on the lane, pins serving from step 2.  (d) the
    checkpoint items: every one run on the cycle thread with no gradient
    batch left in its cycle, at most the budget a cycle, the count
    dispatched, the files' bytes exact.  (c) the autotuner
    (:func:`e10_tune_phase`).  Returns ``(ok, counts)`` (rank 0's
    launches)."""
    import numpy as np
    t_a = time.time()
    results, route, wall = launch_ranks(
        torch, "--e10-worker", layers, seed, timeout_s, 2, E10_FLAGS,
        env_extra={"HOROVOD_TRACE": "1"})
    if results is None:
        return False, None
    a, b = results
    ok = a["tracer"] and b["tracer"]
    want = [E10_MIB << 20, E10_MIB << 20, E10_FAST_KB << 10]
    flags_ok = a["knobs"] == b["knobs"] == want
    ok = ok and flags_ok
    print(f"e10: 2 ranks ({route}) in {wall:.1f} s with "
          f"{' '.join(E10_FLAGS)}, HOROVOD_TRACE=1; the engines' knobs at "
          f"init {a['knobs']} (= the flags: {flags_ok})", flush=True)
    # (a)
    sums = {(x["rank"], m): x["llama"][m]["sums"] for x in results
            for m, *_ in E10_MODES}
    same = len({tuple(v) for v in sums.values()}) == 1
    finite = all(np.isfinite(s["loss"]) for x in results
                 for m in x["llama"].values() for s in m["steps"])
    ok = ok and same and finite
    for label, chunk, part, fast in E10_MODES:
        for x in results:
            m = x["llama"][label]
            d = m["d"]
            steps = E10_STEPS
            good = (m["flash"] == [layers * steps] * 3 and d["acquires"] > 0
                    and d["pack"] == d["unpack"] > 0
                    and d["timed"] == d["batches"])
            if label == "off":
                good = good and d["chunks"] == d["batches"] \
                    and d["splits"] == d["fast"] == 0 \
                    and d["pack"] == d["groups"]
            elif label == "chunked":
                good = good and d["chunks"] > d["batches"] \
                    and d["pack"] == d["chunks"] and d["splits"] == 0
            else:
                good = good and d["splits"] == len(m["split"]) * steps > 0 \
                    and d["fast"] > 0 and d["hits"] > 0
            ok = ok and good
            n = max(1, d["timed"])
            med = sorted(s["s"] for s in m["steps"])[steps // 2]
            print(f"e10 (a) {label} rank {x['rank']}: losses "
                  + " / ".join(f"{s['loss']:.5f}" for s in m["steps"])
                  + f"; step median {med * 1e3:.1f} ms (steps "
                  + ", ".join(f"{s['s'] * 1e3:.0f}" for s in m["steps"])
                  + f"); on the card over the {steps} steps NCCL "
                  f"{d['coll_us'] / 1e3:.1f} ms, pack {d['pack_us'] / 1e3:.2f}"
                  f" ms, unpack {d['unpack_us'] / 1e3:.2f} ms, chunk overlap "
                  f"{d['overlap_us'] / 1e3:.2f} ms ({d['timed']} batches "
                  f"timed, {d['coll_us'] / n / 1e3:.2f} ms NCCL a batch); "
                  f"{d['batches']} batches, {d['chunks']} chunks, "
                  f"{d['groups']} dtype groups, pack/unpack launches "
                  f"{d['pack']}/{d['unpack']}; partition splits "
                  f"{d['splits']} (expected {len(m['split'])} x {steps} from "
                  f"{m['split']}); fast lane {d['fast']} batches, "
                  f"{d['hits']} pin hits; ping-pong acquires "
                  f"{d['acquires']}, waits {d['waits']}; flash {m['flash']}; "
                  f"memory_allocated {m['allocated'] / 2**30:.2f} GiB, peak "
                  f"{m['peak'] / 2**30:.2f} GiB -> "
                  f"{'PASS' if good else 'FAIL'}", flush=True)
    print(f"e10 (a): parameter checksums after {E10_STEPS} steps "
          f"{sums[(0, 'off')]}, equal across the {len(E10_MODES)} modes and "
          f"2 ranks: {same}; losses finite: {finite} -> "
          f"{'PASS' if same and finite else 'FAIL'}", flush=True)
    # (b)
    rs = {(x["rank"], m): (x["resnet"][m]["sums"], x["resnet"][m]["stats"])
          for x in results for m in ("off", "fast")}
    same = len({(tuple(s), tuple(t)) for s, t in rs.values()}) == 1
    ok = ok and same
    for label in ("off", "fast"):
        for x in results:
            ss = x["resnet"][label]["steps"]
            good = all(s["bn"] == E10_BN_EXCHANGES for s in ss)
            if label == "fast":
                good = good and all(
                    s["d"]["fast"] >= E10_BN_EXCHANGES for s in ss) and all(
                    s["d"]["hits"] > 0 for s in ss[1:])
            else:
                good = good and all(s["d"]["fast"] == 0 for s in ss)
            ok = ok and good
            print(f"e10 (b) resnet50 fast lane {label} rank {x['rank']}: "
                  + "; ".join(
                      f"step {i + 1} {s['s'] * 1e3:.1f} ms"
                      + (f" (profiled: rank 0's kernels busy "
                         f"{s['busy'] * 1e3:.1f} ms = "
                         f"{s['busy'] / s['s']:.1%} of it)"
                         if s["busy"] else
                         " (profiled: busy share not measured)"
                         if s["profiled"] else "")
                      + f", {s['bn']} batch-norm exchanges, "
                      f"{s['d']['batches']} batches, fast lane "
                      f"{s['d']['fast']} ({s['d']['hits']} pin hits)"
                      for i, s in enumerate(ss))
                  + f" -> {'PASS' if good else 'FAIL'}", flush=True)
    print(f"e10 (b): parameters and statistics bitwise equal with the fast "
          f"lane off and on, on both ranks: {same} -> "
          f"{'PASS' if same else 'FAIL'}", flush=True)
    # (d)
    for x in results:
        ck = x["ckpt"]
        per_cycle = {}
        for run in ck["runs"]:
            per_cycle[run["cycle"]] = per_cycle.get(run["cycle"], 0) + 1
        good = (ck["dispatched"] == len(ck["runs"]) == E10_CKPT_ITEMS
                and all(not run["grads_left"] and run["on_cycle_thread"]
                        for run in ck["runs"])
                and max(per_cycle.values()) <= ck["budget"]
                and all(ck["files"]))
        ok = ok and good
        print(f"e10 (d) rank {x['rank']}: {E10_CKPT_ITEMS} checkpoint items "
              f"submitted during a step, ckpt_chunks_dispatched "
              f"{ck['dispatched']}; each ran on the cycle thread with no "
              f"gradient batch left in its cycle: "
              f"{all(not u['grads_left'] for u in ck['runs'])}; items a "
              f"cycle {sorted(per_cycle.values())} (budget {ck['budget']}); "
              f"files' bytes exact {sum(ck['files'])}/{E10_CKPT_ITEMS} -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    wall_a = time.time() - t_a
    # (c)
    t_c = time.time()
    good, ta = e10_tune_phase(torch, seed, timeout_s)
    if ta is None:
        return False, None
    ok = ok and good
    print(f"e10: (a), (b), (d) in {wall_a:.1f} s, (c) in "
          f"{time.time() - t_c:.1f} s [{card}; {route}: NCCL's socket "
          f"transport, not NVLink] -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    flash = [sum(a["llama"][m]["flash"][k] for m, *_ in E10_MODES)
             + ta["flash"][k] for k in range(3)]
    pack = (sum(a["llama"][m]["d"]["pack"] for m, *_ in E10_MODES)
            + sum(s["d"]["pack"] for m in ("off", "fast")
                  for s in a["resnet"][m]["steps"]) + ta["pack"])
    unpack = (sum(a["llama"][m]["d"]["unpack"] for m, *_ in E10_MODES)
              + sum(s["d"]["unpack"] for m in ("off", "fast")
                    for s in a["resnet"][m]["steps"]) + ta["unpack"])
    return ok, dict(flash=flash, pack=pack, unpack=unpack)


E11_LAYERS = 1          # one layer keeps the whole script in its limit
E11_STEPS = 7
E11_COMMITS = (1, 3, 5, 7)
E11_KILL_STEP = 4        # generation 1's rank 1 dies in this step's backward
E11_KILL_LEAF = "layers.0.wq"   # ... when this leaf's gradient is computed
E11_LR = 1e-3            # AdamW, its state in the parameters' bf16
E11_CHUNK_MB = 16        # --ckpt-chunk-mb
E11_HOSTS = ("127.0.0.1:1", "127.0.0.2:1")
E11_JOINER = "127.0.0.3:1"
E11_MEM_TOL = 32 * 2**20     # check (7), like with like (see e11_phase)
E11_TIMEOUT_S = 420


def _staging_bytes(eng):
    """The bytes of the engine's ping-pong staging buffers (the fast
    lane, whose pins hold the others, is off in E11)."""
    return sum(st.buf.numel() * st.buf.element_size()
               for st in eng._staging.values() if st.buf is not None)


def _opt_checksum(torch, opt):
    """``_checksum`` over an optimizer's state tensors (AdamW's moments)."""
    sd = opt.state_dict()["state"]
    return _checksum(torch, [(f"{i}.{k}", v) for i in sorted(sd)
                             for k, v in sorted(sd[i].items())
                             if torch.is_tensor(v) and v.dim() > 0])


def e11_worker(args):
    """One worker of E11, started by the port's elastic driver (``python -m
    horovod_tpu_torch.runner --host-discovery-script ...``), in every
    generation it is part of: Llama at full width, ``args.train_layers``
    deep, B=2, T=4096, replicated ``DistributedOptimizer(AdamW)`` under
    ``TorchState`` and ``@hvd.elastic.run``, committed after the steps of
    ``E11_COMMITS``.  Generation 1's rank 1 (``E11_HOSTS[1]``) kills itself
    in step ``E11_KILL_STEP``'s backward; the survivor, alone after its
    restore, appends ``E11_JOINER`` to the host file after step 5's commit
    and waits for the driver's notice.  Every event goes, with its wall
    time, to ``<dir>/<host>.jsonl``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.elastic import stateplane as spl
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    torch.backends.cuda.matmul.allow_tf32 = False
    out = args.e11_worker
    me = os.environ["HOROVOD_HOSTNAME"]
    log = open(os.path.join(out, f"{me}.jsonl"), "a")
    lock = threading.Lock()

    def rec(**kw):
        kw["t"] = time.time()
        with lock:
            log.write(json.dumps(kw) + "\n")
            log.flush()

    rec(ev="start")
    hvd.init()
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1))
    named = list(tl.named_parameters(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=E11_LR),
        named_parameters=named)
    step_fn = tl.make_train_step(cfg, opt)
    state = hvd.elastic.TorchState(params=params, optimizer=opt, step=0)
    restore = spl.maybe_restore

    def timed_restore(st, plane):
        t0 = time.time()
        src = restore(st, plane)
        rec(ev="restore", source=src, s=time.time() - t0,
            disk_reads=plane.disk_reads, shards=plane.peer_shards_fetched,
            epoch=plane.epoch, digest=plane.memory_state()[2])
        return src

    spl.maybe_restore = timed_restore

    # A commit's parts on the train thread: the host copy (``save``), the
    # encode and the digest, each summed over the commit.
    train_tid = threading.get_ident()
    parts = {}

    def timed(name, fn):
        def call(*a, **kw):
            if threading.get_ident() != train_tid:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return call

    spl.encode_state = timed("encode", spl.encode_state)
    spl.blob_digest = timed("digest", spl.blob_digest)
    state.save = timed("save", state.save)

    def kill(grad):
        rec(ev="kill")
        os._exit(1)

    @hvd.elastic.run
    def train(state):
        size, rank = hvd.size(), hvd.rank()
        eng = basics._get_state().engine
        plane = state._stateplane
        enter = dict(size=size, rank=rank, step=state.step,
                     epoch=plane.epoch, source=plane.last_restore_source,
                     t_enter=time.time(),
                     mem=torch.cuda.memory_allocated(dev))
        if size == 1:
            # The survivor after the fault: the card completes the dead
            # generation's work (its communicators were aborted), and the
            # live state is the last commit's bytes.
            t0 = time.time()
            torch.cuda.synchronize()
            enter["synchronize_s"] = time.time() - t0
            t0 = time.time()
            enter["digest"] = spl.blob_digest(spl.encode_state(
                state._saved_state))
            enter["digest_s"] = time.time() - t0
            enter["commit_digest"] = plane.memory_state()[2]
        rec(ev="enter", **enter)
        _zero_flash(fa)
        counts = dict(groups=0, pack=0, unpack=0)
        while state.step < E11_STEPS:
            rng = np.random.RandomState(args.seed + 100 * state.step + rank)
            toks = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
                    np.int64)).to(dev)
            if (me == E11_HOSTS[1].split(":")[0] and size == 2
                    and state.step == E11_KILL_STEP - 1):
                dict(named)[E11_KILL_LEAF].register_hook(kill)
            c0 = (eng.fused_groups, fusion.pack.launches,
                  fusion.unpack.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step_fn(state.params, toks[:, :-1], toks[:, 1:]).item()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            for k, a, b in zip(counts, c0, (eng.fused_groups,
                                            fusion.pack.launches,
                                            fusion.unpack.launches)):
                counts[k] += b - a
            state.step += 1
            sums = _checksum(torch, named) + _opt_checksum(torch, opt)
            every = hvd.allgather_object(sums) if size > 1 else [sums]
            rec(ev="step", step=state.step, size=size, rank=rank, loss=loss,
                s=dt, sums=sums, same=all(x == sums for x in every),
                flash=_flash_counts(fa), counts=dict(counts),
                mem=torch.cuda.memory_allocated(dev),
                staging=_staging_bytes(eng),
                chunks=eng.ckpt_chunks_dispatched)
            if state.step in E11_COMMITS:
                parts.clear()
                t0 = time.perf_counter()
                try:
                    state.commit()
                finally:
                    epoch, blob, digest = plane.memory_state()
                    t1 = time.perf_counter()
                    rec(ev="commit", step=state.step, size=size,
                        epoch=epoch, digest=digest, s=t1 - t0,
                        parts=dict(parts), blob=len(blob or b""))

                    def durable(epoch=epoch, t0=t0, t1=t1):
                        ok = plane.wait_durable(epoch, timeout=300)
                        t = time.perf_counter()
                        rec(ev="durable", epoch=epoch, ok=ok, s=t - t0,
                            after=t - t1)

                    threading.Thread(target=durable, daemon=True).start()
            if size == 1 and state.step == 5:
                with open(os.path.join(out, "hosts"), "a") as fh:
                    fh.write(E11_JOINER + "\n")
                rec(ev="grow")
                t_end = time.time() + 120
                while time.time() < t_end:
                    state.check_host_updates()
                    time.sleep(0.05)
                raise RuntimeError("E11: the driver sent no host update")

    train(state)
    eng = basics._get_state().engine
    hvd.shutdown()
    rec(ev="done", step=state.step, chunks=eng.ckpt_chunks_dispatched)
    return 0


def _e11_events(out):
    """Each worker's events, by host."""
    ev = {}
    for path in glob.glob(os.path.join(out, "*.jsonl")):
        with open(path) as fh:
            ev[os.path.basename(path)[:-6]] = [json.loads(ln) for ln in fh
                                               if ln.strip()]
    return ev


def e11_phase(torch, layers, seed, card, timeout_s=E11_TIMEOUT_S):
    """E11: elastic training through the port's elastic launcher on the
    card.  Two loopback host entries share the card over NCCL's sockets
    (``E11_HOSTS``); ``e11_worker`` trains Llama at full width, ``layers``
    deep; generation 1 (size 2) loses rank 1 mid-backward, generation 2
    (size 1) is the survivor restored to its last commit, generation 3
    (size 2) adds ``E11_JOINER``, restored from the survivor's shard
    server.  Checks: (1) parameters and AdamW state bitwise across the
    ranks after every step; (2) the survivor's state after its restore is
    the last commit's bytes (blob digest); (3) the joiner's restore came
    from the peer, with no disk read, to the survivor's commit digest; (4)
    the newest durable epoch's manifests are on disk for every rank, and a
    disk-only restore decodes to the same digest; (5) finite losses; (6)
    rank 0's launches each generation: each flash kernel layers x steps,
    pack = unpack = the batches' dtype groups; (7) memory_allocated at the
    first step of generation 3 (size 2) within ``E11_MEM_TOL`` of
    generation 1's (size 2), and generation 2's (size 1) within it of
    generation 1's less the staging bytes that size 2 holds and size 1
    does not, each generation's staging measured;
    (8) the survivor's torch.cuda.synchronize() returns after the fault;
    (9) the driver exits 0 and only the killed worker exits non-zero.
    Returns ``(ok, launches)``."""
    import signal
    import tempfile
    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from horovod_tpu_torch.elastic import stateplane as spl
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        hosts, ckpt = os.path.join(tmp, "hosts"), os.path.join(tmp, "ckpt")
        with open(hosts, "w") as fh:
            fh.write("\n".join(E11_HOSTS) + "\n")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
               "--host-discovery-script", f"cat {hosts}", "--min-np", "1",
               "--max-np", "2", "--ckpt-dir", ckpt, "--ckpt-chunk-mb",
               str(E11_CHUNK_MB), "--output-filename",
               os.path.join(tmp, "logs"), "-v", sys.executable,
               os.path.abspath(__file__), "--train-layers", str(layers),
               "--seed", str(seed), "--e11-worker", tmp]
        print(f"e11: python {' '.join(cmd[1:cmd.index('-v') + 1])} python "
              f"chip_smoke.py --e11-worker {tmp} (hosts: "
              f"{', '.join(E11_HOSTS)}, then {E11_JOINER})", flush=True)
        t0 = time.time()
        with open(os.path.join(tmp, "driver.log"), "w") as dlog:
            driver = subprocess.Popen(cmd, cwd=here, env=env, stdout=dlog,
                                      stderr=subprocess.STDOUT,
                                      start_new_session=True)
            try:
                rc = driver.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                rc = None
            finally:
                if driver.poll() is None:
                    os.killpg(driver.pid, signal.SIGKILL)
                    driver.wait()
        wall = time.time() - t0
        stop_strays("e11")
        with open(os.path.join(tmp, "driver.log")) as fh:
            dtext = fh.read()
        ev = _e11_events(tmp)
        if rc != 0:
            tail = dtext[-4000:]
            for r in sorted(glob.glob(os.path.join(tmp, "logs", "*", "*"))):
                with open(r) as fh:
                    tail += f"\n--- {os.path.relpath(r, tmp)}\n" + \
                        fh.read()[-6000:]
            print(f"e11: the elastic run failed (driver rc {rc}, "
                  f"{wall:.1f} s); the end of its output:\n{tail}",
                  flush=True)
            return False, None
        surv, dead = E11_HOSTS[0].split(":")[0], E11_HOSTS[1].split(":")[0]
        join = E11_JOINER.split(":")[0]
        s_ev, d_ev, j_ev = ev.get(surv, []), ev.get(dead, []), \
            ev.get(join, [])

        def of(evs, kind, **kw):
            return [e for e in evs if e["ev"] == kind
                    and all(e.get(k) == v for k, v in kw.items())]

        # The survivor's generations: its "enter" events split its log.
        gens, cur = [], None
        for e in s_ev:
            if e["ev"] == "enter":
                cur = dict(enter=e, steps=[], commits=[])
                gens.append(cur)
            elif cur is not None and e["ev"] == "step":
                cur["steps"].append(e)
            elif cur is not None and e["ev"] == "commit":
                cur["commits"].append(e)
        ok = True
        results = []

        def check(n, good, text):
            nonlocal ok
            ok = ok and good
            results.append(good)
            print(f"e11 ({n}): {text} -> {'PASS' if good else 'FAIL'}",
                  flush=True)

        sizes = [g["enter"]["size"] for g in gens]
        steps_of = [[s["step"] for s in g["steps"]] for g in gens]
        shape_ok = (sizes == [2, 1, 2]
                    and steps_of == [[1, 2, 3], [4, 5], [6, 7]])
        print(f"e11: the survivor's generations: sizes {sizes}, steps "
              f"{steps_of}; the killed worker's last step "
              f"{max([s['step'] for s in of(d_ev, 'step')] or [0])}, kill "
              f"event {bool(of(d_ev, 'kill'))}; the joiner's steps "
              f"{[s['step'] for s in of(j_ev, 'step')]} -> "
              f"{'PASS' if shape_ok else 'FAIL'}", flush=True)
        ok = ok and shape_ok and len(gens) == 3
        if not (shape_ok and len(gens) == 3):
            return False, None
        g1, g2, g3 = gens
        # (1)
        pairs = ([(s, of(d_ev, "step", step=s["step"])) for s in
                  g1["steps"]] + [(s, of(j_ev, "step", step=s["step"]))
                                  for s in g3["steps"]])
        same = all(s["same"] and o and o[0]["sums"] == s["sums"]
                   and o[0]["same"] for s, o in pairs)
        check(1, same, f"parameters and AdamW state bitwise across the two "
              f"ranks after steps {[s['step'] for s, _ in pairs]} "
              f"(checksums exchanged by allgather_object, and the logs "
              f"agree)")
        # (2)
        e2 = g2["enter"]
        check(2, e2["digest"] == e2["commit_digest"]
              and e2["step"] == 3 and e2["epoch"] == g1["commits"][-1][
                  "epoch"],
              f"the survivor restored step {e2['step']}'s commit (epoch "
              f"{e2['epoch']}): its state's blob digest {e2['digest']} "
              f"= the commit's {e2['commit_digest']} (encode + digest "
              f"{e2['digest_s']:.1f} s)")
        # (3)
        jr = of(j_ev, "restore")
        sc = g2["commits"][-1]
        good = bool(jr) and jr[0]["source"] == "peer" \
            and jr[0]["disk_reads"] == 0 and jr[0]["digest"] == \
            sc["digest"] and jr[0]["epoch"] == sc["epoch"]
        check(3, good, f"the joiner restored epoch "
              f"{jr[0]['epoch'] if jr else None} from "
              f"{jr[0]['source'] if jr else None} ({jr[0]['shards'] if jr else 0}"
              f" shard(s), {jr[0]['disk_reads'] if jr else None} disk reads) "
              f"in {jr[0]['s'] if jr else 0:.1f} s, digest "
              f"{jr[0]['digest'] if jr else None} = the survivor's step-5 "
              f"commit {sc['digest']}")
        # (4)
        epoch = spl.latest_complete_epoch(ckpt)
        mans = spl.epoch_manifests(ckpt, epoch) if epoch is not None else None
        last = g3["commits"][-1]
        t_d = time.time()
        plane = spl.StatePlane(ckpt, serve=False)
        data, depoch, source = plane.restore()
        # The digest the restore verified of the bytes it decoded.
        disk_digest = plane.memory_state()[2]
        keys = sorted(data)
        t_d = time.time() - t_d
        del data, plane
        good = (mans is not None and len(mans) == 2
                and sorted(m["rank"] for m in mans) == [0, 1]
                and epoch == last["epoch"] == depoch and source == "disk"
                and disk_digest == last["digest"]
                == mans[0]["blob_digest"]
                and keys == ["optimizer", "params", "step"])
        check(4, good, f"epoch {epoch} is the newest complete on disk with "
              f"{len(mans or [])} manifests (world "
              f"{mans[0]['world'] if mans else None}); a disk-only restore "
              f"({len(mans or [])} shard files read, verified and decoded "
              f"to {keys} in {t_d:.1f} s) gives digest {disk_digest} = the "
              f"last commit's {last['digest']}")
        # (5)
        losses = [s["loss"] for g in gens for s in g["steps"]] + \
            [s["loss"] for s in of(d_ev, "step") + of(j_ev, "step")]
        check(5, all(np.isfinite(losses)),
              f"losses {[round(x, 4) for x in losses]} finite")
        # (6)
        launches = []
        good = True
        for i, g in enumerate(gens):
            last_s = g["steps"][-1]
            n = len(g["steps"])
            fl, c = last_s["flash"], last_s["counts"]
            launches.append(fl + [c["pack"], c["unpack"]])
            good = good and fl == [layers * n] * 3 and c["pack"] == \
                c["unpack"] == c["groups"] > 0
        check(6, good, "rank 0's launches a generation, [fwd, dq, dkv, pack, "
              f"unpack]: {launches} over {[len(g['steps']) for g in gens]} "
              f"steps of {layers} layers; dtype groups "
              f"{[g['steps'][-1]['counts']['groups'] for g in gens]}")
        # (7) Like with like: generation 3 against generation 1 (both
        # size 2); generation 2 (size 1) against generation 1 less the
        # staging bytes the sizes differ by.  A dead generation's leak
        # shows as a difference above the limit.
        mems = [g["steps"][0]["mem"] for g in gens]
        stag = [g["steps"][0]["staging"] for g in gens]
        want2 = mems[0] - (stag[0] - stag[1])
        d3, d2 = mems[2] - mems[0], mems[1] - want2
        check(7, abs(d3) <= E11_MEM_TOL and abs(d2) <= E11_MEM_TOL,
              f"memory_allocated at each generation's first step "
              f"{[m / 2**30 for m in mems]} GiB, the engine's staging "
              f"{[b / 2**30 for b in stag]} GiB; generation 3 - "
              f"generation 1 = {d3 / 2**20:+.3f} MiB, generation 2 - "
              f"(generation 1 - the staging it lacks, "
              f"{want2 / 2**30:.6f} GiB) = {d2 / 2**20:+.3f} MiB (each "
              f"within {E11_MEM_TOL / 2**20:.0f} MiB; at each "
              f"generation's entry "
              f"{[g['enter']['mem'] / 2**30 for g in gens]} GiB)")
        # (8)
        check(8, "synchronize_s" in e2,
              f"the survivor's torch.cuda.synchronize() after the fault "
              f"returned in {e2.get('synchronize_s', float('nan')):.3f} s")
        # (9)
        fails = re.findall(r"elastic driver: (\S+) failed rc=(-?\d+)", dtext)
        check(9, rc == 0 and fails == [(f"{dead}:0", "1")]
              and bool(of(s_ev, "done")) and bool(of(j_ev, "done")),
              f"driver rc {rc}; non-zero worker exits {fails}; the survivor "
              f"and the joiner finished")
        # Times.
        kill_t = of(d_ev, "kill")[0]["t"]
        rec_s = g2["steps"][0]["t"] - g2["steps"][0]["s"] - kill_t
        entry_s = e2["t_enter"] - kill_t
        grow_t = of(s_ev, "grow")[0]["t"]
        grow_s = g3["steps"][0]["t"] - g3["steps"][0]["s"] - grow_t
        commits = [(c["step"], c["size"], round(c["s"], 3))
                   for c in of(s_ev, "commit")]
        cparts = [(c["step"], round(c["parts"].get("save", 0.0), 3),
                   round(c["parts"].get("encode", 0.0), 3),
                   round(c["parts"].get("digest", 0.0), 3),
                   round(c["blob"] / 1e9 / c["parts"]["digest"], 3)
                   if c["parts"].get("digest") else None)
                  for c in of(s_ev, "commit")]
        durable = [(d["epoch"], d["ok"], round(d["after"], 3))
                   for d in of(s_ev, "durable")]
        print(f"e11 times [{card}; NCCL's socket transport on one card]: "
              f"recovery (kill -> generation 2's first step starts) "
              f"{rec_s:.2f} s, of which the checks (2) and (8) "
              f"{e2['synchronize_s'] + e2['digest_s']:.2f} s (kill -> the "
              f"train function's entry {entry_s:.2f} s); growth (host file "
              f"-> generation 3's first "
              f"step starts) {grow_s:.2f} s; commit() on the train thread "
              f"(step, size, s) {commits}, its parts (step, the host copy "
              f"save() s, encode_state s, blob_digest s, blob_digest GB/s "
              f"over the {of(s_ev, 'commit')[0]['blob'] / 1e9:.3f} GB "
              f"blob) {cparts}; the durable write, commit's "
              f"return -> wait_durable (epoch, ok, s) {durable}; the "
              f"joiner's peer restore "
              f"{jr[0]['s']:.2f} s; steps (s) a generation "
              + "; ".join(", ".join(f"{s['s']:.3f}" for s in g["steps"])
                          for g in gens)
              + f"; ckpt_chunks_dispatched at each generation's last step "
              f"{[g['steps'][-1]['chunks'] for g in gens]}, at the end "
              f"{of(s_ev, 'done')[0]['chunks']} (survivor) and "
              f"{of(j_ev, 'done')[0]['chunks']} (joiner); the whole run "
              f"{wall:.1f} s", flush=True)
        print(f"e11: {sum(results)}/9 checks -> "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        total = [sum(x[k] for x in launches) for k in range(5)]
        return ok, dict(flash=total[:3], pack=total[3], unpack=total[4])


E12_LAYERS = 1
E12_LR = 1e-3            # AdamW, its state in the parameters' bf16
E12_STOPS = {0: 3, 3: 5, 5: 7}   # a generation trains from its entry step
E12_COMMITS = (1, 5)     # and commits after these steps (and on request)
E12_HOSTS = ("127.0.0.1:2", "127.0.0.2:1")
E12_DRAINED = "127.0.0.2"
E12_MIN_NP = 2           # the policy may scale a world of 3 in, not of 2
E12_GRACE_S = 90         # --preempt-grace-s: a drained rank's commit first
E12_CHUNK_MB = 16
E12_FLAP_S = 4           # the preempted host's absence from discovery
E12_TIMEOUT_S = 420
# The driver's policy (Config.from_env in run_elastic): an idle world of 3
# scales in after 20 s without progress, longer than a commit's blocking
# pass on the train thread (the idle detector cannot tell the two apart);
# scale-out and eviction are kept off by their thresholds.
E12_AUTOSCALE_ENV = {"HOROVOD_AUTOSCALE_IDLE_S": "20",
                     "HOROVOD_AUTOSCALE_PERSISTENCE": "2",
                     "HOROVOD_AUTOSCALE_COOLDOWN": "3",
                     "HOROVOD_AUTOSCALE_STRAGGLER_FACTOR": "50",
                     "HOROVOD_AUTOSCALE_QUEUE_HIGH": "1e9",
                     "HOROVOD_AUTOSCALE_QUEUE_TREND": "1e9"}


def _e12_paths(tmp):
    return {k: os.path.join(tmp, k) for k in ("hosts", "notice", "scaled",
                                             "ckpt", "logs", "driver.json")}


def e12_driver(args):
    """E12's elastic driver, a child of ``e12_phase``: ``run_elastic`` on
    the launcher's arguments for the autoscaled, drained, two-level job,
    with the script discovery's class given preemption notices read from
    ``<dir>/notice`` (the script source reports none) and the driver's
    class recording, for the phase, its events, the identities it records
    LEFT, the times of its COMMIT fan-outs and DRAIN pings and its exit
    code into ``<dir>/driver.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.common.net import free_ports
    from horovod_tpu_torch.elastic import driver as drv
    from horovod_tpu_torch.runner import run as prun
    p = _e12_paths(args.e12_driver)

    class NoticeDiscovery(drv.HostDiscoveryScript):
        def preemption_notices(self):
            try:
                with open(p["notice"]) as fh:
                    return {ln.strip() for ln in fh if ln.strip()}
            except FileNotFoundError:
                return set()

    class Recording(drv.ElasticDriver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.left, self.pings = [], []
            record_left = self.registry.record_left
            self.registry.record_left = lambda i: (
                self.left.append([i, time.time()]), record_left(i))[1]

        def _request_commit_all(self, wait_s=2.0):
            t0 = time.time()
            acks = super()._request_commit_all(wait_s=wait_s)
            self.events[-1]["s"] = time.time() - t0
            return acks

        def drain_worker(self, identity):
            ok = super().drain_worker(identity)
            self.pings.append([identity, ok, time.time()])
            return ok

        def run(self):
            rc = None
            try:
                rc = super().run()
                return rc
            finally:
                with open(p["driver.json"], "w") as fh:
                    json.dump(dict(
                        rc=rc, events=self.events, left=self.left,
                        pings=self.pings,
                        blacklisted=sorted(
                            h for h in ("127.0.0.1", E12_DRAINED)
                            if self.registry.is_blacklisted(h))), fh)

    drv.HostDiscoveryScript = NoticeDiscovery
    drv.ElasticDriver = Recording
    mon, = free_ports(1)
    argv = ["--host-discovery-script", f"cat {p['hosts']}", "--min-np",
            str(E12_MIN_NP), "--max-np", "3", "--hierarchical-controller",
            "--autoscale", "--autoscale-interval", "1", "--monitor",
            "--monitor-port", str(mon), "--monitor-interval", "1",
            "--ckpt-dir", p["ckpt"], "--ckpt-chunk-mb", str(E12_CHUNK_MB),
            "--commit-max-age-s", "600", "--preempt-grace-s",
            str(E12_GRACE_S), "--scale-command",
            f'echo "$HVD_AUTOSCALE_ACTION $HVD_AUTOSCALE_HOST" >> '
            f'{p["scaled"]}', "--output-filename", p["logs"], "-v",
            sys.executable, os.path.abspath(__file__), "--train-layers",
            str(args.train_layers), "--seed", str(args.seed),
            "--e12-worker", args.e12_driver]
    return drv.run_elastic(prun.parse_args(argv))


def e12_worker(args):
    """One worker of E12, in every generation it is part of: Llama at full
    width, ``args.train_layers`` deep, B=2, T=4096, replicated
    ``DistributedOptimizer(AdamW)`` under ``TorchState`` and
    ``@hvd.elastic.run``.  A generation trains from the step it enters at
    to the next of ``E12_STOPS`` (committing after ``E12_COMMITS``), then
    idles: it commits when ``state.should_commit()`` says the driver asked
    and polls ``state.check_host_updates()``.  Rank 0 acts out the host's
    life on the phase's behalf: after generation 1 it posts the preemption
    notice for ``E12_DRAINED``; after generation 2 the host leaves the
    host file for ``E12_FLAP_S`` seconds while its notice clears, then is
    listed again.  A generation entered at step 7 returns at once.  Where
    the host has fewer cards than ranks (host 0's two on one card), a rank
    computes on ``cuda:0`` with an ``NCCL_HOSTID`` of its own.  Every
    event goes, with its wall time, to ``<dir>/<host>.<local
    rank>.<pid>.jsonl``."""
    import ctypes
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import controller as ctl_mod
    from horovod_tpu_torch.elastic import stateplane as spl
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = args.e12_worker
    p = _e12_paths(tmp)
    me = os.environ["HOROVOD_HOSTNAME"]
    ident = f"{me}.{os.environ.get('HOROVOD_LOCAL_RANK', '0')}"
    log = open(os.path.join(tmp, f"{ident}.{os.getpid()}.jsonl"), "a")
    lock = threading.Lock()

    def rec(**kw):
        kw["t"] = time.time()
        with lock:
            log.write(json.dumps(kw) + "\n")
            log.flush()

    leave = ctl_mod.TCPController.leave

    def recorded_leave(self):
        ok = leave(self)
        rec(ev="leave", ok=bool(ok))
        return ok

    ctl_mod.TCPController.leave = recorded_leave
    restore = spl.maybe_restore

    def timed_restore(st, plane):
        t0 = time.time()
        src = restore(st, plane)
        rec(ev="restore", source=src, s=time.time() - t0,
            disk_reads=plane.disk_reads, shards=plane.peer_shards_fetched,
            epoch=plane.epoch, digest=plane.memory_state()[2])
        return src

    spl.maybe_restore = timed_restore

    def agent():
        a = basics._get_state().host_agent
        return None if a is None else dict(port=a.port, ranks=a.ranks,
                                           **vars(a.stats))

    def root():
        """The root coordinator's rounds served and mean service µs (the
        process of rank 0 hosts it)."""
        ctl = basics._get_state().controller
        if ctl is None or not getattr(ctl, "_server", None):
            return None
        out = (ctypes.c_double * 2)()
        ctl._lib.hvdtpu_server_stats(ctl._server, out)
        return [out[0], out[1]]

    rec(ev="start")
    # Host 0's two ranks share the one card: each its own NCCL host id (a
    # host of its own to NCCL, whose sockets join them), both on cuda:0.
    local_rank = int(os.environ.get("HOROVOD_LOCAL_RANK", "0"))
    device = None
    if torch.cuda.device_count() <= local_rank:
        os.environ["NCCL_HOSTID"] = \
            f"{os.environ.get('NCCL_HOSTID', 'hvd')}-{local_rank}"
        device = "cuda:0"
    hvd.init(device=device)
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=args.train_layers)
    params = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 1))
    named = list(tl.named_parameters(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in named], lr=E12_LR),
        named_parameters=named)
    step_fn = tl.make_train_step(cfg, opt)
    state = hvd.elastic.TorchState(params=params, optimizer=opt, step=0)
    _restore = state.restore

    def rollback():
        rec(ev="rollback", step=state.step)
        return _restore()

    state.restore = rollback

    def sums():
        return _checksum(torch, named) + _opt_checksum(torch, opt)

    def commit(why):
        plane = state._stateplane
        t0 = time.perf_counter()
        rec(ev="commit_start", step=state.step, why=why)
        try:
            state.commit()      # ends with the update check: may raise
        finally:
            epoch, blob, digest = plane.memory_state()
            rec(ev="commit", step=state.step, why=why, epoch=epoch,
                digest=digest, s=time.perf_counter() - t0,
                blob=len(blob or b""))

    def idle():
        t_end = time.time() + 300
        while time.time() < t_end:
            if state.should_commit():
                commit("request")
            state.check_host_updates()
            time.sleep(0.05)
        raise RuntimeError("E12: the driver sent no host update")

    @hvd.elastic.run
    def train(state):
        size, rank = hvd.size(), hvd.rank()
        eng = basics._get_state().engine
        plane = state._stateplane
        entered = state.step
        rec(ev="enter", size=size, rank=rank, step=entered,
            epoch=plane.epoch, source=plane.last_restore_source,
            disk_reads=plane.disk_reads, sums=sums(), agent=agent(),
            mem=torch.cuda.memory_allocated(dev))
        if entered not in E12_STOPS:
            return "done"
        _zero_flash(fa)
        counts = dict(groups=0, pack=0, unpack=0)
        while state.step < E12_STOPS[entered]:
            rng = np.random.RandomState(args.seed + 100 * state.step + rank)
            toks = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
                    np.int64)).to(dev)
            c0 = (eng.fused_groups, fusion.pack.launches,
                  fusion.unpack.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step_fn(state.params, toks[:, :-1], toks[:, 1:]).item()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            for k, a, b in zip(counts, c0, (eng.fused_groups,
                                            fusion.pack.launches,
                                            fusion.unpack.launches)):
                counts[k] += b - a
            state.step += 1
            s = sums()
            every = hvd.allgather_object(s)
            rec(ev="step", step=state.step, size=size, rank=rank, loss=loss,
                s=dt, sums=s, same=all(x == s for x in every),
                flash=_flash_counts(fa), counts=dict(counts),
                mem=torch.cuda.memory_allocated(dev))
            if state.step in E12_COMMITS:
                commit("step")
        rec(ev="trained", step=state.step, size=size, agent=agent(),
            root=root())
        if rank == 0 and state.step == 3:
            with open(p["notice"], "w") as fh:
                fh.write(E12_DRAINED + "\n")
            rec(ev="notice")
        if rank == 0 and state.step == 5:
            with open(p["hosts"]) as fh:
                listed = fh.read()
            with open(p["hosts"], "w") as fh:
                fh.write(listed.splitlines()[0] + "\n")
            with open(p["notice"], "w") as fh:
                fh.write("")
            rec(ev="notice_cleared")
            time.sleep(E12_FLAP_S)
            with open(p["hosts"], "w") as fh:
                fh.write(listed)
            rec(ev="relisted")
        idle()

    res = train(state)
    inited = hvd.is_initialized()
    rec(ev="done", step=state.step, res=res, initialized=inited,
        agent=agent(), root=root() if inited else None)
    if inited:
        hvd.shutdown()
    return 0


def _e12_events(tmp):
    """Each worker process's events, by identity (``<host>.<local
    rank>``), the processes in the order they started."""
    procs = {}
    for path in glob.glob(os.path.join(tmp, "*.jsonl")):
        with open(path) as fh:
            evs = [json.loads(ln) for ln in fh if ln.strip()]
        if evs:
            procs.setdefault(os.path.basename(path).rsplit(".", 2)[0],
                             []).append(evs)
    return {i: sorted(ps, key=lambda evs: evs[0]["t"])
            for i, ps in procs.items()}


def e12_phase(torch, layers, seed, card, timeout_s=E12_TIMEOUT_S):
    """E12: the rest of elastic through the port's driver on the card.
    ``e12_driver`` runs ``run_elastic`` with ``--hierarchical-controller
    --autoscale --monitor-port <p> --ckpt-dir <tmp> --commit-max-age-s 600
    --preempt-grace-s 90 --scale-command ...`` over ``E12_HOSTS`` (three
    ranks on one card over NCCL's sockets, two behind host 0's agent),
    with notices from a file; ``e12_worker`` trains Llama at full width,
    ``layers`` deep.  Generation 1 (size 3) trains steps 1-3 and the
    notice drains ``E12_DRAINED``; generation 2 (size 2) trains steps 4-5
    from the survivors' live state; the host returns and generation 3
    (size 3) has a fresh worker there restored from a peer, steps 6-7, then
    every worker idles until the policy, reading rank 0's ``/health``,
    scales the world in; generation 4 (size 2) ends.  Checks: (1) the
    generations' sizes 3, 2, 3, 2, the driver's decisions ``preempt_drain``
    then ``scale_in`` of ``E12_DRAINED``, every commit request acked; (2)
    both drained workers left by a clean LEAVE and exited 0 before the
    grace (no termination, no blacklist, LEFT twice), and no survivor's
    training function saw a fault (no rollback, no traceback); (3)
    generation 2 starts from generation 1's last state bitwise, with no
    restore (the HostsUpdatedInterrupt sync); (4) generation 3's joiner
    restored from a peer with 0 disk reads to the survivors' step-5 commit
    digest; (5) host 0's agent served the four generations, on the
    aggregate path in generations 1 and 3, and host 1's last uplink (a
    round owed no answer: its one rank left) carried the LEAVE;
    (6) the scale command's file holds ``scale_in`` of the host; (7) the
    parameters and AdamW state bitwise across the ranks after every step;
    (8) rank 0's launches each generation: each flash kernel layers x
    steps, pack = unpack = the batches' dtype groups.  Returns ``(ok,
    launches)``."""
    import signal
    import tempfile
    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **E12_AUTOSCALE_ENV, PYTHONPATH=os.pathsep.join(
        [here] + [q for q in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if q]))
    with tempfile.TemporaryDirectory() as tmp:
        p = _e12_paths(tmp)
        with open(p["hosts"], "w") as fh:
            fh.write("\n".join(E12_HOSTS) + "\n")
        cmd = [sys.executable, os.path.abspath(__file__), "--train-layers",
               str(layers), "--seed", str(seed), "--e12-driver", tmp]
        print(f"e12: run_elastic over {', '.join(E12_HOSTS)} with "
              f"--hierarchical-controller --autoscale --monitor-port <free> "
              f"--preempt-grace-s {E12_GRACE_S} --commit-max-age-s 600 "
              f"--min-np {E12_MIN_NP} --max-np 3 and "
              f"{' '.join(f'{k}={v}' for k, v in E12_AUTOSCALE_ENV.items())}"
              f"; preemption notices from a file", flush=True)
        t0 = time.time()
        with open(os.path.join(tmp, "driver.log"), "w") as dlog:
            driver = subprocess.Popen(cmd, cwd=here, env=env, stdout=dlog,
                                      stderr=subprocess.STDOUT,
                                      start_new_session=True)
            try:
                rc = driver.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                rc = None
            finally:
                if driver.poll() is None:
                    os.killpg(driver.pid, signal.SIGKILL)
                    driver.wait()
        wall = time.time() - t0
        stop_strays("e12")
        with open(os.path.join(tmp, "driver.log")) as fh:
            dtext = fh.read()
        wtext = ""
        for r in sorted(glob.glob(os.path.join(p["logs"], "*", "*"))):
            with open(r) as fh:
                wtext += f"\n--- {os.path.relpath(r, tmp)}\n" + fh.read()
        ev = _e12_events(tmp)
        try:
            with open(p["driver.json"]) as fh:
                dres = json.load(fh)
        except (OSError, ValueError):
            dres = None
        if rc != 0 or dres is None:
            print(f"e12: the elastic run failed (driver rc {rc}, "
                  f"{wall:.1f} s); the end of its output:\n{dtext[-4000:]}"
                  f"{wtext[-12000:]}", flush=True)
            return False, None
        ok = True
        results = []

        def check(n, good, text):
            nonlocal ok
            ok = ok and good
            results.append(good)
            print(f"e12 ({n}): {text} -> {'PASS' if good else 'FAIL'}",
                  flush=True)

        def of(evs, kind):
            return [e for e in evs if e["ev"] == kind]

        r0 = [e for evs in ev.get("127.0.0.1.0", []) for e in evs]
        r1 = [e for evs in ev.get("127.0.0.1.1", []) for e in evs]
        host1 = ev.get(f"{E12_DRAINED}.0", [])
        # Rank 0's generations: its "enter" events split its log.
        gens, cur = [], None
        for e in r0:
            if e["ev"] == "enter":
                cur = dict(enter=e, steps=[], commits=[], trained=None)
                gens.append(cur)
            elif cur is not None and e["ev"] == "step":
                cur["steps"].append(e)
            elif cur is not None and e["ev"] == "commit":
                cur["commits"].append(e)
            elif cur is not None and e["ev"] == "trained":
                cur["trained"] = e
        sizes = [g["enter"]["size"] for g in gens]
        steps_of = [[s["step"] for s in g["steps"]] for g in gens]
        shape_ok = (sizes == [3, 2, 3, 2] and steps_of == [[1, 2, 3], [4, 5],
                                                           [6, 7], []]
                    and len(host1) == 2)
        print(f"e12: rank 0's generations: sizes {sizes}, steps {steps_of}; "
              f"{E12_DRAINED}'s workers {len(host1)} -> "
              f"{'PASS' if shape_ok else 'FAIL'}", flush=True)
        if not shape_ok:
            print(f"e12: the end of the output:\n{dtext[-4000:]}"
                  f"{wtext[-8000:]}", flush=True)
            return False, None
        g1, g2, g3, g4 = gens
        drained1, joiner = host1
        events = dres["events"]
        decisions = [e for e in events if e["action"] != "commit_request"]
        requests = [e for e in events if e["action"] == "commit_request"]
        # (1)
        good = ([(e["action"], e.get("host")) for e in decisions]
                == [("preempt_drain", E12_DRAINED), ("scale_in", E12_DRAINED)]
                and len(requests) == 2
                and all(r["acks"] and all(r["acks"].values())
                        for r in requests))
        check(1, good, f"generation sizes {sizes}; the driver's decisions "
              f"{[(e['action'], e.get('host')) for e in decisions]}; commit "
              f"requests acked {[r['acked'] for r in requests]} of "
              f"{[sorted(r['acks']) for r in requests]}")
        # (2)
        grace = re.findall(r"drain grace .* expired for (\S+)", dtext)
        bad_exit = re.findall(r"(?:exited|failed) rc=(-?\d+)", dtext)
        leaves = [of(w, "leave") for w in host1]
        dones = [of(w, "done") for w in host1]
        rollbacks = [e for evs in ev.values() for w in evs for e in w
                     if e["ev"] == "rollback"]
        hvd303 = len(re.findall(r"HVD303", wtext))
        good = (not grace and not bad_exit and not dres["blacklisted"]
                and [x[0] for x in dres["left"]] == [f"{E12_DRAINED}:0"] * 2
                and all(lv and lv[0]["ok"] for lv in leaves)
                and all(d and d[0]["res"] is None
                        and not d[0]["initialized"] for d in dones)
                and not rollbacks and "Traceback" not in wtext
                and "PeerFailureError" not in wtext
                and "HorovodInternalError" not in wtext)
        check(2, good, f"both drained workers sent a clean LEAVE "
              f"({[lv[0]['ok'] if lv else None for lv in leaves]}) and "
              f"exited 0 (non-zero exits {bad_exit}, grace terminations "
              f"{grace}); recorded LEFT {[x[0] for x in dres['left']]}, "
              f"blacklisted {dres['blacklisted']}; rollbacks "
              f"{len(rollbacks)}, tracebacks {wtext.count('Traceback')}; "
              f"HVD303 warnings in the workers' logs {hvd303} (an idle "
              f"host-mate of rank 0 when rank 0 re-rendezvoused first)")
        # (3)
        e2 = g2["enter"]
        last1 = g1["steps"][-1]
        good = (e2["step"] == last1["step"] == 3 and e2["source"] is None
                and e2["sums"] == last1["sums"])
        check(3, good, f"generation 2 entered at step {e2['step']} (the "
              f"last of generation 1: {last1['step']}) with no restore "
              f"(source {e2['source']}: the HostsUpdatedInterrupt sync of "
              f"the commit taken at the drain), its parameters and AdamW "
              f"state {e2['sums']} = step 3's {last1['sums']}")
        # (4)
        jr = of(joiner, "restore")
        c5 = [c for c in g2["commits"] if c["step"] == 5]
        good = (bool(jr) and bool(c5) and jr[0]["source"] == "peer"
                and jr[0]["disk_reads"] == 0
                and jr[0]["digest"] == c5[0]["digest"]
                and jr[0]["epoch"] == c5[0]["epoch"])
        check(4, good, f"the fresh worker on {E12_DRAINED} restored epoch "
              f"{jr[0]['epoch'] if jr else None} from "
              f"{jr[0]['source'] if jr else None} "
              f"({jr[0]['shards'] if jr else 0} shard(s), "
              f"{jr[0]['disk_reads'] if jr else None} disk reads) in "
              f"{jr[0]['s'] if jr else 0:.2f} s, digest "
              f"{jr[0]['digest'] if jr else None} = the survivors' step-5 "
              f"commit {c5[0]['digest'] if c5 else None}")
        # (5)
        a_in = [g["enter"]["agent"] for g in gens]
        a_out = [g["trained"]["agent"] if g["trained"] else None
                 for g in gens]
        agg = [(b["agg_rounds"] - a["agg_rounds"]) if a and b else None
               for a, b in zip(a_in, a_out)]
        h1 = [of(w, "done")[0]["agent"] for w in host1]
        roots = [g["trained"]["root"] if g["trained"] else None
                 for g in gens]
        good = (a_in[3] is not None and a_in[3]["generations"] == 4
                and len({a["port"] for a in a_in if a}) == 1
                and agg[0] and agg[0] > 0 and agg[2] and agg[2] > 0
                and all(a and a["uplink_frames"] == a["rounds"]
                        == a["responses_fanned"] + 1 for a in h1)
                and of(r1, "enter")[0]["agent"] is None)
        check(5, good, f"host 0's agent (port {a_in[0]['port']}) served "
              f"generations {[a['generations'] if a else None for a in a_in]}"
              f" with ranks {[a['ranks'] if a else None for a in a_in]}, "
              f"aggregate rounds a generation {agg}, uplinks = rounds "
              f"{[(a['uplink_frames'], a['rounds']) for a in a_out if a]}; "
              f"host 1's agents' last uplink carried the LEAVE and was owed "
              f"no response (rounds, uplinks, responses "
              f"{[(a['rounds'], a['uplink_frames'], a['responses_fanned'])
                  for a in h1 if a]}; leaves_forwarded, counted when the "
              f"root's answer retires the rank, "
              f"{[a['leaves_forwarded'] if a else None for a in h1]}); the "
              f"root (hvdtpu_server_stats: rounds served, mean service us) "
              f"in generations 1-3 {roots[:3]}, host 0's uplinks in "
              f"generation 1 {a_out[0]['uplink_frames']}: one a round a "
              f"host")
        # (6)
        try:
            with open(p["scaled"]) as fh:
                scaled = fh.read().split()
        except OSError:
            scaled = []
        check(6, scaled == ["scale_in", E12_DRAINED],
              f"the scale command's file holds {scaled}")
        # (7)
        pairs = []
        for g in gens:
            for s in g["steps"]:
                peers = [e for evs in ev.values() for w in evs for e in w
                         if e["ev"] == "step" and e["step"] == s["step"]
                         and e["size"] == s["size"]]
                pairs.append((s, peers))
        good = all(s["same"] and len(o) == s["size"]
                   and all(x["sums"] == s["sums"] and x["same"] for x in o)
                   for s, o in pairs)
        check(7, good, f"parameters and AdamW state bitwise across the "
              f"ranks after steps {[s['step'] for s, _ in pairs]} "
              f"(checksums exchanged by allgather_object, and the logs "
              f"agree)")
        # (8)
        launches = []
        good = True
        for g in gens[:3]:
            last_s = g["steps"][-1]
            n = len(g["steps"])
            fl, c = last_s["flash"], last_s["counts"]
            launches.append(fl + [c["pack"], c["unpack"]])
            good = good and fl == [layers * n] * 3 and c["pack"] == \
                c["unpack"] == c["groups"] > 0
        check(8, good, "rank 0's launches a generation, [fwd, dq, dkv, pack, "
              f"unpack]: {launches} over {[len(g['steps']) for g in gens]} "
              f"steps of {layers} layers; dtype groups "
              f"{[g['steps'][-1]['counts']['groups'] for g in gens[:3]]}")
        losses = [s["loss"] for g in gens for s in g["steps"]]
        if not all(np.isfinite(losses)):
            ok = False
            print(f"e12: losses {losses} not finite -> FAIL", flush=True)
        # Times.
        ts = {d["action"]: d["ts"] for d in decisions}
        notice_t = of(r0, "notice")[0]["t"]
        drain_ping = [x for x in dres["pings"] if x[0] ==
                      f"{E12_DRAINED}:0"]
        exit1 = of(drained1, "done")[0]["t"]
        first2 = g2["steps"][0]["t"] - g2["steps"][0]["s"]
        relisted = of(r0, "relisted")[0]["t"]
        first3 = g3["steps"][0]["t"] - g3["steps"][0]["s"]
        last3 = g3["steps"][-1]["t"]
        exit2 = of(joiner, "done")[0]["t"]
        commits = [(c["step"], c["why"], round(c["s"], 3))
                   for c in of(r0, "commit")]
        step_s = {n: [round(s["s"], 3) for g in gens for s in g["steps"]
                      if s["size"] == n] for n in (3, 2)}
        mems = [round(g["steps"][0]["mem"] / 2**30, 6) if g["steps"]
                else round(g["enter"]["mem"] / 2**30, 6) for g in gens]
        print(f"e12 times [{card}; NCCL's socket transport on one card, "
              f"three ranks]: notice -> the drained worker's exit "
              f"{exit1 - notice_t:.2f} s (notice -> the driver's "
              f"preempt_drain {ts['preempt_drain'] - notice_t:.2f} s; the "
              f"COMMIT fan-out to its acks {requests[0]['s']:.3f} s; the "
              f"DRAIN ping -> the exit {exit1 - drain_ping[0][2]:.2f} s, by "
              f"clean LEAVE); the DRAIN ping -> generation 2's first step "
              f"{first2 - drain_ping[0][2]:.2f} s; growth (the host listed "
              f"again -> generation 3's first step) {first3 - relisted:.2f}"
              f" s, the peer restore {jr[0]['s'] if jr else 0:.2f} s; the "
              f"last step -> SCALE_IN {ts['scale_in'] - last3:.2f} s "
              f"(HOROVOD_AUTOSCALE_IDLE_S "
              f"{E12_AUTOSCALE_ENV['HOROVOD_AUTOSCALE_IDLE_S']}), its "
              f"COMMIT fan-out {requests[1]['s']:.3f} s, the DRAIN ping -> "
              f"the exit {exit2 - drain_ping[1][2]:.2f} s; commit() on rank "
              f"0 (step, why, s) {commits}; steps (s) at size 3 "
              f"{step_s[3]}, at size 2 {step_s[2]}; memory_allocated at "
              f"each generation's first step {mems} GiB; the whole run "
              f"{wall:.1f} s", flush=True)
        print(f"e12: {sum(results)}/8 checks -> "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        total = [sum(x[k] for x in launches) for k in range(5)]
        return ok, dict(flash=total[:3], pack=total[3], unpack=total[4])


# ----------------------------------------------- E13: expert parallelism
E13_LAYERS = 1           # Mixtral-8x7B at full width, cut to one layer
E13_SEQ = 2048           # tokens a rank (B = 1)
E13_STEPS = 3
E13_LR = 1e-3            # AdamW, its state in the parameters' bf16
# MLPerf DLRM's published widths (Criteo Terabyte): 26 tables x 128, 13
# dense features, bottom MLP 512-256-128, top MLP 1024-1024-512-256-1 over
# the JAX model's concatenated interaction; the rows cut from MLPerf's 40 M
# cap to 1 M a table (13.3 GB of float32 tables), so that both ranks and
# the reference fit the one card.
E13_DLRM = dict(n_tables=26, rows_per_table=1_000_000, embed_dim=128,
                dense_dim=13, bottom_mlp=(512, 256, 128),
                top_mlp=(1024, 1024, 512, 256, 1))
E13_DLRM_BATCH = 4096    # a rank
E13_DLRM_LR = 0.1        # SGD, tests/test_models.py:136's
E13_LOSS_RTOL = 2e-4     # tests/test_models.py:136's tolerances
E13_TABLE_TOL = dict(rtol=2e-3, atol=1e-6)
# Those levels cannot see a wrong table update at these widths: a row is
# hit about once a run, its update ~1e-7 against the limit's ~2e-5.  So
# the updates themselves (after minus before) are held, as the relative
# norm of their difference from the ep-off run's over each table's
# touched rows and over each MLP leaf, and the loss's change from step 1
# against the ep-off run's.  A sound run reads float32 rounding there; a
# table without its step, or without the 1/ep factor, reads about 1.
E13_UPDATE_TOL = 0.05
E13_LOSS_CHANGE_TOL = 0.05


def _joined(vals, fmt="{:.1f}"):
    return " / ".join(fmt.format(v) for v in vals)


def _rel_norm(torch, a, b):
    """``‖a − b‖ / ‖b‖`` in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _e13_moe(torch, np, hvd, args, mesh, progress):
    """E13 (a) on this rank: Mixtral at full width on ``{ep: n}``."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl, moe
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import expert
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    cfg = tl.mixtral_8x7b(n_layers=E13_LAYERS)
    specs = tl.param_specs(cfg)
    # Every rank draws every expert from one seed, then keeps its slab.
    full = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 13))
    toks = torch.from_numpy(np.random.RandomState(args.seed + 14).randint(
        0, cfg.vocab_size, (n, E13_SEQ + 1)).astype(np.int64)).to(dev)
    xs, ys = toks[:, :-1], toks[:, 1:]
    # The reference: every expert local (no mesh), the ranks' sequences in
    # turn, gradients averaged: the sharded step's global loss exactly
    # (the aux loss is per sequence here as it is per rank there).
    full_named = list(tl.named_parameters(full))
    for i in range(n):
        (tl.loss_fn(full, xs[i:i + 1], ys[i:i + 1], cfg) / n).backward()
    slab = expert.spec_of(specs)
    e_loc = cfg.n_experts // n
    ref = {}
    for name, t in full_named:
        g = t.grad
        ref[name] = (g[r * e_loc:(r + 1) * e_loc].clone()
                     if slab[name] == cfg.ep_axis else g)
        t.grad = None
    params = tl.shard_experts(full, cfg, mesh)
    del full, full_named, g
    torch.cuda.empty_cache()
    progress("(a) reference gradients done")
    named = list(tl.named_parameters(params))
    rep, sh = expert.split_named(named, specs)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in rep], lr=E13_LR),
        named_parameters=rep)
    eps = expert.ExpertParallel(
        mesh, torch.optim.AdamW([t for _, t in sh], lr=E13_LR))
    eps.broadcast_parameters(named, specs, root_rank=0)
    step = tl.make_train_step(cfg, opt, mesh, eps)
    x, y = xs[r:r + 1].contiguous(), ys[r:r + 1].contiguous()
    steps, grad_err = [], {}
    for i in range(E13_STEPS):
        _zero_flash(fa)
        moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
        mesh.timing = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 0:
            # The step's own sequence, opened for the gradient check.
            opt.zero_grad()
            eps.zero_grad()
            loss = tl.loss_fn(params, x, y, cfg, mesh)
            loss.backward()
            opt.synchronize()
            eps.sync_grads()
            grad_err = {nm: _rel_norm(torch, t.grad, ref[nm])
                        for nm, t in named}
            with opt.skip_synchronize():
                opt.step()
            eps.optimizer.step()
            loss = loss.detach()
        else:
            loss = step(params, x, y)
        lv = loss.item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        marks, mesh.timing = mesh.timing, None
        steps.append(dict(
            loss=lv, s=dt, a2a=len(marks), a2a_ms=parallel.timed_ms(marks),
            launches=_flash_counts(fa), routed=moe.moe_ffn.routed,
            dropped=int(moe.moe_ffn.dropped),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            rep=_checksum(torch, rep), slab=_checksum(torch, sh)))
        if i == 0:
            del ref
        progress(f"(a) step {i + 1} done")
    eps.shutdown()
    return dict(steps=steps, grad_err=grad_err,
                leaves=[len(rep), len(sh)],
                slab_gib=sum(t.numel() * t.element_size()
                             for _, t in sh) / 2**30)


def _e13_dlrm(torch, np, hvd, args, mesh, progress):
    """E13 (b) on this rank: DLRM at MLPerf widths on ``{ep: n}``; the
    touched rows of this rank's tables and the MLPs go to
    ``dlrm<rank>.pt`` for the reference in the parent."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import dlrm, llama as tl
    from horovod_tpu_torch.parallel import expert
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    cfg = dlrm.DLRMConfig(**E13_DLRM)
    specs = dlrm.param_specs(cfg)
    t_loc = cfg.n_tables // n
    mine = range(r * t_loc, (r + 1) * t_loc)
    params = dlrm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 15), dev, tables=mine)
    batch = dlrm.synthetic_batch(cfg, n * E13_DLRM_BATCH, args.seed + 16)
    b = E13_DLRM_BATCH
    dense, ids, labels = (torch.from_numpy(a[r * b:(r + 1) * b]).to(dev)
                          for a in batch)
    named = list(tl.named_parameters(params))
    rep, sh = expert.split_named(named, specs)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([t for _, t in rep], lr=E13_DLRM_LR),
        named_parameters=rep)
    eps = expert.ExpertParallel(
        mesh, torch.optim.SGD([t for _, t in sh], lr=E13_DLRM_LR))
    step = dlrm.make_train_step(cfg, opt, mesh, eps)
    # The rows the global batch touches in this rank's tables, and their
    # values (and the MLPs') before the steps: the updates go to the
    # reference with the values after.
    every = torch.from_numpy(batch[1]).to(dev).long()
    rows = {j: torch.unique(every[:, j]) for j in mine}
    before = {j: params["tables"][i][rows[j]].detach().clone()
              for i, j in enumerate(mine)}
    mlp_before = {nm: t.detach().clone() for nm, t in rep}
    progress("(b) tables drawn")
    steps = []
    for _ in range(E13_STEPS):
        mesh.timing = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(params, dense, ids, labels)
        lv = loss.item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        marks, mesh.timing = mesh.timing, None
        steps.append(dict(
            loss=lv, mean=dlrm.psum_loss(loss, mesh).item(), s=dt,
            exchanges=len(marks), exchange_ms=parallel.timed_ms(marks),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            mlp=_checksum(torch, rep)))
    touched = {}
    for i, j in enumerate(mine):
        after = params["tables"][i][rows[j]].detach()
        touched[j] = (rows[j].cpu(), after.cpu(), (after - before[j]).cpu())
    mlp = {nm: (t.detach().cpu(), (t.detach() - mlp_before[nm]).cpu())
           for nm, t in rep}
    torch.save(dict(rows=touched, mlp=mlp),
               os.path.join(args.e14_worker, f"dlrm{r}.pt"))
    eps.shutdown()
    progress("(b) steps done")
    return dict(steps=steps, tables=len(mine),
                table_gib=params["tables"].numel() * 4 / 2**30)


def _e13_dlrm_reference(torch, seed, n, saved, dev="cuda:0"):
    """E13 (b)'s reference in this process: the same DLRM, every table
    here (ep off), the global batch, the same SGD steps; then the ranks'
    MLPs and every table row the steps touched against it, as values
    (within E13_TABLE_TOL) and as updates (the relative norm of the
    difference, a table's touched rows or an MLP leaf at a time).
    Returns ``(losses, held, worst, rows)``: ``worst`` holds the largest
    value errors and update norms, and the updates' RMS."""
    from horovod_tpu_torch.models import dlrm, llama as tl
    dev = torch.device(dev)
    cfg = dlrm.DLRMConfig(**E13_DLRM)
    params = dlrm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 15), dev)
    batch = [torch.from_numpy(a).to(dev) for a in dlrm.synthetic_batch(
        cfg, n * E13_DLRM_BATCH, seed + 16)]
    named = list(tl.named_parameters(params))
    mine = dict(named)
    before = {j: params["tables"][j][ids.to(dev)].detach().clone()
              for s in saved for j, (ids, _, _) in s["rows"].items()}
    mlp_before = {nm: mine[nm].detach().clone() for nm in saved[0]["mlp"]}
    step = dlrm.make_train_step(cfg, torch.optim.SGD(
        [t for _, t in named], lr=E13_DLRM_LR))
    losses = [step(params, *batch).item() for _ in range(E13_STEPS)]
    worst = dict(table=0.0, mlp=0.0, table_update=0.0, mlp_update=0.0,
                 table_rms=0.0, mlp_rms=0.0)
    held = True

    def hold(got, want, upd, want_upd, what):
        nonlocal held
        got, upd = got.to(dev), upd.to(dev)
        err = (got - want).abs()
        rel = _rel_norm(torch, upd, want_upd)
        held = held and bool((err <= E13_TABLE_TOL["atol"] + E13_TABLE_TOL[
            "rtol"] * want.abs()).all()) and rel <= E13_UPDATE_TOL
        worst[what] = max(worst[what], float(err.max()) if err.numel()
                          else 0.0)
        worst[f"{what}_update"] = max(worst[f"{what}_update"], rel)
        worst[f"{what}_rms"] = max(worst[f"{what}_rms"], float(
            want_upd.float().pow(2).mean().sqrt()))

    rows = 0
    with torch.no_grad():
        for s in saved:
            for j, (ids, got, upd) in s["rows"].items():
                want = params["tables"][j][ids.to(dev)]
                hold(got, want, upd, want - before[j], "table")
                rows += ids.numel()
            for name, (got, upd) in s["mlp"].items():
                hold(got, mine[name], upd, mine[name] - mlp_before[name],
                     "mlp")
    del params, named, mine, batch, before, mlp_before
    torch.cuda.empty_cache()
    return losses, held, worst, rows


def _e13_report(torch, np, results, saved, layers, seed, card, route,
                wall):
    """E13's checks and lines, from the ranks' records of the launch E13
    shares with E14 and E15 (``e14_worker``), on ``{ep: 2}``.  (a) Mixtral
    at full width: every
    leaf's step-1 gradient (the replicated leaves world-averaged, the slab
    after the 1/ep rule) within GRAD_TOL (relative norm) of the reference
    with every expert local; the replicated leaves bitwise equal across
    the ranks after every step and the slabs not; no token dropped; the
    flash launches ``layers`` each a step on each rank; finite losses.
    (b) DLRM at MLPerf's widths: the world's mean loss each step within
    E13_LOSS_RTOL of the ep-off reference run here and its change from
    step 1 within E13_LOSS_CHANGE_TOL of the reference's, the MLPs and
    every table row the steps touched within E13_TABLE_TOL and their
    updates within E13_UPDATE_TOL (relative norm) of the reference's, the
    MLPs bitwise across the ranks.  ``saved``: each rank's
    ``dlrm<rank>.pt``."""
    n = len(results)
    ok = True
    # (a) MoE.
    runs = [res["moe"] for res in results]
    for i, steps in enumerate(zip(*(m["steps"] for m in runs))):
        rep_same = len({str(st["rep"]) for st in steps}) == 1
        slab_differ = len({str(st["slab"]) for st in steps}) == n
        finite = all(np.isfinite(st["loss"]) for st in steps)
        no_drop = all(st["dropped"] == 0 and st["routed"] > 0
                      for st in steps)
        launches = all(st["launches"] == [layers] * 3 for st in steps)
        good = rep_same and slab_differ and finite and no_drop and launches
        ok = ok and good
        print(f"e13 (a): step {i + 1}: losses "
              f"{[round(st['loss'], 6) for st in steps]}; replicated "
              f"leaves bitwise equal across ranks: {rep_same}; expert "
              f"slabs differ: {slab_differ}; tokens routed / dropped "
              f"{[(st['routed'], st['dropped']) for st in steps]}; flash "
              f"launches fwd/dq/dkv {[st['launches'] for st in steps]}; "
              f"step {_joined(st['s'] * 1e3 for st in steps)} ms"
              f"{' (with the gradient check)' if i == 0 else ''}; "
              f"{steps[0]['a2a']} all-to-alls taking "
              f"{_joined(st['a2a_ms'] for st in steps)} ms; "
              f"peak {max(st['peak_gib'] for st in steps):.2f} GiB -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    for res, m in zip(results, runs):
        worst = max(m["grad_err"].values())
        good = worst <= GRAD_TOL
        ok = ok and good
        name = max(m["grad_err"], key=m["grad_err"].get)
        print(f"e13 (a): rank {res['rank']}: step-1 gradients of "
              f"{sum(m['leaves'])} leaves ({m['leaves'][1]} of them the "
              f"slab, {m['slab_gib']:.2f} GiB) against every expert "
              f"local: worst relative norm {worst:.3e} ({name}; tol "
              f"{GRAD_TOL:g}) -> {'PASS' if good else 'FAIL'}", flush=True)
    a = runs[0]["steps"][1:]
    med = sorted(st["s"] for st in a)[len(a) // 2] * 1e3
    a2a = sorted(st["a2a_ms"] for st in a)[len(a) // 2]
    print(f"e13 (a): Mixtral-8x7B width, {layers} layer, 8 experts top-2 "
          f"(capacity factor 4.0), ep = {n}: step {med:.1f} ms on rank 0 "
          f"(the median of steps 2-{E13_STEPS}), all-to-all {a2a:.1f} ms "
          f"of it (CUDA events around the exchanges), "
          f"{n * E13_SEQ / med * 1e3:.1f} tokens/s over both ranks, peak "
          f"{max(st['peak_gib'] for m in runs for st in m['steps']):.2f} "
          f"GiB a rank, the rank's (a) in {runs[0]['wall']:.1f} s [{card}; "
          f"two ranks on {route}]", flush=True)
    # (b) DLRM.
    runs = [res["dlrm"] for res in results]
    ref, held, worst, rows = _e13_dlrm_reference(torch, seed, n, saved)
    first = runs[0]["steps"][0]["mean"]
    for i, steps in enumerate(zip(*(d["steps"] for d in runs))):
        mean = steps[0]["mean"]
        rel = abs(mean - ref[i]) / abs(ref[i])
        # The loss's change from step 1 (none at step 1 itself).
        change = (abs((mean - first) - (ref[i] - ref[0]))
                  / abs(ref[i] - ref[0]) if i else 0.0)
        mlp_same = len({str(st["mlp"]) for st in steps}) == 1
        good = (rel <= E13_LOSS_RTOL and change <= E13_LOSS_CHANGE_TOL
                and mlp_same and all(abs(st["mean"] - mean) == 0
                                     for st in steps))
        ok = ok and good
        print(f"e13 (b): step {i + 1}: the ranks' losses "
              f"{[round(st['loss'], 6) for st in steps]}, world mean "
              f"{mean:.6f} against the ep-off run's {ref[i]:.6f} (relative "
              f"{rel:.2e}, tol {E13_LOSS_RTOL:g}); its change from step 1 "
              f"{mean - first:.3e} against {ref[i] - ref[0]:.3e} (relative "
              f"{change:.2e}, tol {E13_LOSS_CHANGE_TOL:g}); MLPs bitwise "
              f"across ranks: {mlp_same}; step "
              f"{_joined(st['s'] * 1e3 for st in steps)} ms, "
              f"{steps[0]['exchanges']} exchanges taking "
              f"{_joined(st['exchange_ms'] for st in steps)} ms -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    ok = ok and held
    print(f"e13 (b): {rows:,} touched table rows and the MLPs after "
          f"{E13_STEPS} steps against the ep-off run: worst abs error "
          f"rows {worst['table']:.3e}, MLPs {worst['mlp']:.3e} (rtol "
          f"{E13_TABLE_TOL['rtol']:g}, atol {E13_TABLE_TOL['atol']:g}); "
          f"their updates (RMS rows {worst['table_rms']:.3e}, MLP leaves "
          f"up to {worst['mlp_rms']:.3e}) against the ep-off run's: worst "
          f"relative norm a table {worst['table_update']:.3e}, an MLP leaf "
          f"{worst['mlp_update']:.3e} (tol {E13_UPDATE_TOL:g}) -> "
          f"{'PASS' if held else 'FAIL'}", flush=True)
    b = runs[0]["steps"]
    med = sorted(st["s"] for st in b)[len(b) // 2] * 1e3
    print(f"e13 (b): DLRM at MLPerf's widths, {E13_DLRM['n_tables']} tables "
          f"x {E13_DLRM['rows_per_table']:,} rows x "
          f"{E13_DLRM['embed_dim']} ({runs[0]['tables']} a rank, "
          f"{runs[0]['table_gib']:.2f} GiB), batch {E13_DLRM_BATCH} a rank: "
          f"step {med:.1f} ms on rank 0 (median of {E13_STEPS}), "
          f"{n * E13_DLRM_BATCH / med * 1e3:.0f} samples/s, peak "
          f"{max(st['peak_gib'] for d in runs for st in d['steps']):.2f} "
          f"GiB a rank [{card}; two ranks on {route}]", flush=True)
    print(f"e13: E13 on rank 0 in {results[0]['e13_wall']:.1f} s of the "
          f"launch's {wall:.1f} s -> {'PASS' if ok else 'FAIL'}", flush=True)
    flash = [sum(st["launches"][k] for st in results[0]["moe"]["steps"])
             for k in range(3)]
    return ok, dict(flash=flash)


# ---------------------------------------------- E14: tensor parallelism
E14_LAYERS = 2           # Llama-3-8B at full width, cut to two layers
E14_SEQ = TRAIN_SEQ      # tokens (B = 1), the same on both tp ranks
E14_STEPS = 3
E14_LR = 1e-3            # AdamW, its state in the parameters' bf16
E14_PROMPTS = 2          # (b): prompts of E14_PROMPT tokens, E14_NEW new
E14_PROMPT = 512
E14_NEW = 8
E14_BERT_LAYERS = 4      # (c): BERT-Large's width, B=8 x T=512 (E6's)
E14_BERT_BATCH = 8
E14_BERT_SEQ = 512
E14_TIMEOUT_S = 420      # E13, E14 and E15 in one launch


def _e14_ref_grads(torch, tl, parallel, full, loss, specs, mesh):
    """``loss`` backward through the whole (tp-off) tree ``full``; each
    leaf's gradient cut to this rank's block, the tree's grads cleared."""
    loss.backward()
    spec = parallel.spec_of(specs)
    ref = {}
    for name, t in tl.named_parameters(full):
        s = parallel.split_of(spec[name])
        g = t.grad
        if s is not None and s.axis in mesh.axis_names:
            g = parallel.shard_tree(g, s, mesh.index(s.axis),
                                    mesh.size(s.axis), s.axis)
        ref[name] = g
        t.grad = None
    return ref


def _e14_train(torch, np, hvd, args, mesh, progress):
    """E14 (a) on this rank: Llama-3-8B width on ``{tp: n}``."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=E14_LAYERS)
    specs = tl.param_specs(cfg)
    # Every rank draws the whole model from one seed, then keeps its
    # blocks; the tokens are the same on every tp rank.
    full = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 17))
    toks = torch.from_numpy(np.random.RandomState(args.seed + 18).randint(
        0, cfg.vocab_size, (1, E14_SEQ + 1)).astype(np.int64)).to(dev)
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    # The reference: the tp-off model from the same weights and tokens.
    ref = _e14_ref_grads(torch, tl, parallel, full,
                         tl.loss_fn(full, x, y, cfg), specs, mesh)
    params = tl.shard_params(full, cfg, mesh)
    del full
    torch.cuda.empty_cache()
    progress("(a) reference gradients done")
    named = list(tl.named_parameters(params))
    rep, sh = parallel.split_named(named, specs, (cfg.tp_axis,))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in rep], lr=E14_LR),
        named_parameters=rep)
    shards = parallel.ShardedParallel(
        mesh, torch.optim.AdamW([t for _, t in sh], lr=E14_LR), sh, specs)
    shards.broadcast_parameters(named, specs, root_rank=0)
    step = tl.make_train_step(cfg, opt, mesh, shards)
    steps, grad_err = [], {}
    for i in range(E14_STEPS):
        _zero_flash(fa)
        mesh.timing = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 0:
            # The step opened for the gradient check.
            opt.zero_grad()
            shards.zero_grad()
            loss = tl.loss_fn(params, x, y, cfg, mesh)
            loss.backward()
            opt.synchronize()
            shards.sync_grads()
            grad_err = {nm: _rel_norm(torch, t.grad, ref[nm])
                        for nm, t in named}
            with opt.skip_synchronize():
                opt.step()
            shards.optimizer.step()
            loss = loss.detach()
        else:
            loss = step(params, x, y)
        lv = loss.item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        marks, mesh.timing = mesh.timing, None
        steps.append(dict(
            loss=lv, s=dt, psums=len(marks),
            psum_ms=parallel.timed_ms(marks), launches=_flash_counts(fa),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            rep=_checksum(torch, rep), shards=_checksum(torch, sh)))
        if i == 0:
            del ref
        progress(f"(a) step {i + 1} done")
    shards.shutdown()
    d = cfg.d_model
    return dict(steps=steps, grad_err=grad_err, leaves=[len(rep), len(sh)],
                psum_bytes=4 * E14_SEQ * d * 2 * E14_LAYERS,
                allreduce_bytes=sum(t.numel() * t.element_size()
                                    for _, t in rep),
                shard_gib=sum(t.numel() * t.element_size()
                              for _, t in sh) / 2**30)


def _e14_decode(torch, np, hvd, args, mesh, progress):
    """E14 (b) on this rank: prefill and greedy decode at tp = n against
    the tp-off model on this rank, fed the tp-off run's tokens."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=E14_LAYERS)
    full = tl.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 19))
    for _, t in tl.named_parameters(full):
        t.requires_grad_(False)
    prompts = torch.from_numpy(np.random.RandomState(args.seed + 20).randint(
        0, cfg.vocab_size, (E14_PROMPTS, E14_PROMPT)).astype(np.int64)).to(
        dev)
    slots = E14_PROMPT + E14_NEW
    ref_logits, cache = tl.prefill(full, tl.init_cache(cfg, E14_PROMPTS,
                                                       slots, dev),
                                   prompts, cfg)
    toks, ref_steps = [tl.sample_logits(ref_logits)], []
    for t in range(E14_PROMPT, slots - 1):
        logits, cache = tl.decode_step(full, cache, toks[-1], t, cfg)
        ref_steps.append(logits)
        toks.append(tl.sample_logits(logits))
    del cache
    params = tl.shard_params(full, cfg, mesh)
    del full
    torch.cuda.empty_cache()
    _zero_flash(fa)
    cache = tl.init_cache(cfg, E14_PROMPTS, slots, dev, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tl.prefill(params, cache, prompts, cfg, mesh)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    errs = [_rel_norm(torch, logits, ref_logits)]
    step_ms = []
    for i, t in enumerate(range(E14_PROMPT, slots - 1)):
        t0 = time.perf_counter()
        logits, cache = tl.decode_step(params, cache, toks[i], t, cfg, mesh)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(_rel_norm(torch, logits, ref_steps[i]))
    kv_heads = [cache[0]["k"].shape[2], cfg.n_kv_heads // mesh.size("tp")]
    del cache
    gen = tl.generate(params, prompts, E14_NEW, cfg, mesh=mesh)
    torch.cuda.synchronize()
    progress("(b) decode done")
    return dict(errs=errs, kv_heads=kv_heads, gen=gen.tolist(),
                ref=torch.stack(toks, dim=1).tolist(),
                prefill_ms=prefill_ms, step_ms=step_ms,
                launches=_flash_counts(fa))


def _e14_bert(torch, np, hvd, args, mesh, progress):
    """E14 (c) on this rank: BERT-Large's width at E14_BERT_LAYERS on
    ``{tp: n}``, one step against the tp-off model's gradients."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import bert as tb
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    cfg = tb.bert_large(n_layers=E14_BERT_LAYERS)
    specs = tb.param_specs(cfg)
    full = tb.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 21))
    batch = _mlm_batch(torch, cfg, E14_BERT_BATCH, E14_BERT_SEQ, 0.15,
                       args.seed + 22, dev)
    ref = _e14_ref_grads(torch, tb, parallel, full,
                         tb.mlm_loss_fn(full, *batch, cfg), specs, mesh)
    params = parallel.shard_on_mesh(full, specs, mesh)
    del full
    named = list(tb.named_parameters(params))
    rep, sh = parallel.split_named(named, specs, (cfg.tp_axis,))
    opt = _sgd(torch, hvd, rep, MODEL_LR)
    shards = parallel.ShardedParallel(
        mesh, torch.optim.SGD([t for _, t in sh], lr=MODEL_LR), sh, specs)
    _zero_flash(fa)
    opt.zero_grad()
    loss = tb.mlm_loss_fn(params, *batch, cfg, mesh)
    loss.backward()
    opt.synchronize()
    shards.sync_grads()
    grad_err = {nm: (_rel_norm(torch, t.grad, ref[nm]),
                     torch.nn.functional.cosine_similarity(
                         t.grad.float().flatten(), ref[nm].float().flatten(),
                         dim=0).item()) for nm, t in named}
    diff2 = sum(float((t.grad.float() - ref[nm].float()).square().sum())
                for nm, t in named)
    ref2 = sum(float(ref[nm].float().square().sum()) for nm, _ in named)
    with opt.skip_synchronize():
        opt.step()
    shards.optimizer.step()
    lv = loss.item()
    torch.cuda.synchronize()
    launches = _flash_counts(fa)
    shards.shutdown()
    progress("(c) BERT step done")
    return dict(loss=lv, grad_err=grad_err, launches=launches,
                whole=(diff2 / max(ref2, 1e-30)) ** 0.5,
                leaves=[len(rep), len(sh)],
                heads=cfg.n_heads // mesh.size("tp"))


E15_LAYERS = 2           # Llama-3-8B at full width, one layer a stage
E15_BATCH = 2            # B x E15_SEQ tokens, the same on both stages
E15_SEQ = TRAIN_SEQ
E15_MICRO = 2            # microbatches: mb = 1
E15_STEPS = 2            # cut from 3: the script's time (PERF.md §6 PR 18)
E15_LR = 1e-3            # AdamW, its state in the parameters' bf16


def _e15_params(torch, tl, parallel, args, mesh, cfg, dev, ref=False):
    """This stage's parameters (the stacked slab cut for ``cfg``) from the
    pp-off model drawn from the seed, and the tokens; with ``ref`` also the
    pp-off model's step-1 gradients cut the same way."""
    import numpy as np
    cfg0 = tl.llama3_8b(n_layers=E15_LAYERS)
    full = tl.init_params(cfg0, torch.Generator(device=dev).manual_seed(
        args.seed + 23))
    toks = torch.from_numpy(np.random.RandomState(args.seed + 24).randint(
        0, cfg.vocab_size, (E15_BATCH, E15_SEQ + 1)).astype(np.int64)).to(
        dev)
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    grads = None
    if ref:
        tl.loss_fn(full, x, y, cfg0).backward()
        tree = {k: (v.grad if k != "layers" else
                    [{n: t.grad for n, t in lay.items()} for lay in v])
                for k, v in full.items()}
        grads = dict(tl.named_parameters(tl.shard_params(
            tl.stack_layers(tree), cfg, mesh)))
        for _, t in tl.named_parameters(full):
            t.grad = None
    params = tl.shard_params(tl.stack_layers(full), cfg, mesh)
    del full
    torch.cuda.empty_cache()
    return params, x, y, grads


def _e15_open_step(torch, fa, tl, params, x, y, cfg, mesh, opt, shards):
    """One step opened after the gradients' sync: ``(loss, the step's
    peak above its start (GiB), the launches)``; the gradients stay on the
    leaves until the optimizers step."""
    _zero_flash(fa)
    opt.zero_grad()
    shards.zero_grad()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = tl.loss_fn(params, x, y, cfg, mesh)
    loss.backward()
    opt.synchronize()
    shards.sync_grads()
    torch.cuda.synchronize()
    return (loss.detach(), (torch.cuda.max_memory_allocated() - base) / 2**30,
            _flash_counts(fa))


def _e15_optimizers(torch, hvd, parallel, named, specs, mesh):
    rep, sh = parallel.split_named(named, specs, ("pp",))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([t for _, t in rep], lr=E15_LR),
        named_parameters=rep)
    shards = parallel.ShardedParallel(
        mesh, torch.optim.AdamW([t for _, t in sh], lr=E15_LR), sh, specs)
    return rep, sh, opt, shards


def _e15_train(torch, np, hvd, args, mesh, progress):
    """E15 (a) on this rank: Llama-3-8B width, one layer a stage on ``{pp:
    n}``, ``pp_loss="broadcast"``.  Returns its record and the step-1
    gradients (for (b))."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=E15_LAYERS, pp_axis="pp",
                       n_microbatches=E15_MICRO, pp_loss="broadcast")
    specs = tl.param_specs(cfg)
    params, x, y, ref = _e15_params(torch, tl, parallel, args, mesh, cfg,
                                    dev, ref=True)
    progress("(a) reference gradients done")
    named = list(tl.named_parameters(params))
    rep, sh, opt, shards = _e15_optimizers(torch, hvd, parallel, named,
                                           specs, mesh)
    step = tl.make_train_step(cfg, opt, mesh, shards)
    steps, grad_err, grads1 = [], {}, {}
    for i in range(E15_STEPS):
        mesh.timing = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, peak, launches = _e15_open_step(
                torch, fa, tl, params, x, y, cfg, mesh, opt, shards)
            grad_err = {nm: _rel_norm(torch, t.grad, ref[nm])
                        for nm, t in named}
            grads1 = {nm: t.grad.clone() for nm, t in named}
            with opt.skip_synchronize():
                opt.step()
            shards.optimizer.step()
        else:
            _zero_flash(fa)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss = step(params, x, y)
            launches = _flash_counts(fa)
        lv = loss.item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i > 0:
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        marks, mesh.timing = mesh.timing, None
        steps.append(dict(
            loss=lv, s=dt, exchanges=len(marks),
            exchange_ms=parallel.timed_ms(marks), launches=launches,
            peak_gib=peak, total_gib=torch.cuda.max_memory_allocated() / 2**30,
            rep=_checksum(torch, rep), shards=_checksum(torch, sh)))
        if i == 0:
            del ref
        progress(f"(a) step {i + 1} done")
    shards.shutdown()
    d = cfg.d_model
    return dict(steps=steps, grad_err=grad_err, leaves=[len(rep), len(sh)],
                stage=mesh.index("pp"),
                hop_bytes=E15_BATCH // E15_MICRO * E15_SEQ * d * 2,
                psum_bytes=E15_BATCH * E15_SEQ * d * 2,
                slab_gib=sum(t.numel() * t.element_size()
                             for _, t in sh) / 2**30), grads1


def _e15_remat(torch, np, hvd, args, mesh, progress, grads_a):
    """E15 (b) on this rank: one step at ``pp_loss="last_stage"`` with
    ``remat_stages``, from (a)'s weights and tokens: its step-1 gradients
    against (a)'s, its peak, its launches and exchanges."""
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    cfg = tl.llama3_8b(n_layers=E15_LAYERS, pp_axis="pp",
                       n_microbatches=E15_MICRO, pp_loss="last_stage",
                       remat_stages=True)
    specs = tl.param_specs(cfg)
    params, x, y, _ = _e15_params(torch, tl, parallel, args, mesh, cfg, dev)
    named = list(tl.named_parameters(params))
    rep, sh, opt, shards = _e15_optimizers(torch, hvd, parallel, named,
                                           specs, mesh)
    mesh.timing = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, peak, launches = _e15_open_step(torch, fa, tl, params, x, y, cfg,
                                          mesh, opt, shards)
    dt = time.perf_counter() - t0
    marks, mesh.timing = mesh.timing, None
    grad_err = {nm: _rel_norm(torch, t.grad, grads_a[nm]) for nm, t in named}
    with opt.skip_synchronize():
        opt.step()
    shards.optimizer.step()
    lv = loss.item()
    shards.shutdown()
    progress("(b) remat step done")
    return dict(loss=lv, s=dt, peak_gib=peak, launches=launches,
                exchanges=len(marks), exchange_ms=parallel.timed_ms(marks),
                grad_err=grad_err)


def e14_worker(args):
    """One rank of E13, E14 and E15, started by the port's launcher: first
    E13 on ``make_mesh({"ep": 2})`` (``_e13_moe``, ``_e13_dlrm``), then E14
    on ``make_mesh({"tp": 2})``: (a) Llama-3-8B at full width, E14_LAYERS deep, bf16, B=1 x
    E14_SEQ tokens on both ranks, the replicated leaves through
    ``DistributedOptimizer(AdamW)`` and the tp shards through
    ``ShardedParallel(AdamW)``, E14_STEPS steps: step 1 opened for the
    gradient check against the tp-off model from the same weights and
    tokens, the launch counts zeroed before each step and read after, the
    reductions' marks, the losses and the checksums of the replicated
    leaves and of the shards; (b) E14_PROMPTS prompts of E14_PROMPT
    tokens, prefill and E14_NEW greedy tokens at tp = 2 against the tp-off
    run on this rank; (c) BERT-Large's width at E14_BERT_LAYERS, one step's
    gradients against tp-off.  Then E15 in the same world, on
    ``make_mesh({"pp": 2})`` (``_e15_train``, ``_e15_remat``).  Writes
    ``rank<HOROVOD_RANK>.json`` in ``args.e14_worker``."""
    import faulthandler
    import gc
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    stacks = open(os.path.join(args.e14_worker, "stacks"
                               f"{os.environ['HOROVOD_RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(E14_TIMEOUT_S - 30, exit=False,
                                      file=stacks)
    hvd.init()
    r, n = hvd.rank(), hvd.size()
    t_start = time.perf_counter()

    def progress(what):
        print(f"e13-e15 rank {r}: {what} at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    res = dict(rank=r, size=n, card=torch.cuda.get_device_name(
        hvd.device()))
    # E13 first, in the same world: expert parallelism on {ep: n}.
    mesh = parallel.make_mesh({"ep": n})
    for part, fn in (("moe", _e13_moe), ("dlrm", _e13_dlrm)):
        t0 = time.perf_counter()
        res[part] = fn(torch, np, hvd, args, mesh, progress)
        res[part]["wall"] = time.perf_counter() - t0
        gc.collect()        # the DLRM's 6.7 GB of tables, before E14's
        torch.cuda.empty_cache()
    res["e13_wall"] = time.perf_counter() - t_start
    mesh.shutdown()
    t14 = time.perf_counter()
    mesh = parallel.make_mesh({"tp": n})
    for part, fn in (("train", _e14_train), ("decode", _e14_decode),
                     ("bert", _e14_bert)):
        t0 = time.perf_counter()
        res[part] = fn(torch, np, hvd, args, mesh, progress)
        res[part]["wall"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    res["e14_wall"] = time.perf_counter() - t14
    mesh.shutdown()
    # E15 in the same world: pipeline parallelism on {pp: n}.
    t0 = time.perf_counter()
    mesh = parallel.make_mesh({"pp": n})
    res["pp"], grads = _e15_train(torch, np, hvd, args, mesh, progress)
    res["pp"]["wall"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    res["pp_remat"] = _e15_remat(torch, np, hvd, args, mesh, progress, grads)
    del grads
    res["e15_wall"] = time.perf_counter() - t0
    mesh.shutdown()
    hvd.shutdown()
    faulthandler.cancel_dump_traceback_later()
    stacks.close()
    _write_result(args.e14_worker, res)
    print(f"e14 rank {r}: done", flush=True)
    return 0


def e14_phase(torch, layers, seed, card, timeout_s=E14_TIMEOUT_S):
    """E14: tensor parallelism on two ranks through the port's launcher
    (``e14_worker``), on ``{tp: 2}``.  (a) Llama-3-8B at full width: every
    leaf's step-1 gradient (the replicated leaves world-averaged, the tp
    shards through ``ShardedParallel``) within GRAD_TOL (relative norm) of
    the matching block of the tp-off model's; after every step the
    replicated leaves bitwise equal across the ranks and the shards not,
    the losses finite and bitwise equal across the ranks; the flash
    launches ``layers`` each a step on each rank.  (b) The prefill logits
    and every decode step's within DECODE_TOL of tp-off's, the cache at
    n_kv_heads / 2 heads a rank, the generated tokens bitwise equal across
    the ranks.  (c) BERT-Large's width: the whole gradient and every leaf's
    but wq/wk within GRAD_TOL (relative norm) of tp-off's, wq/wk by their
    cosine (QK_COS_TOL, E6's rule and reason), the flash launches
    E14_BERT_LAYERS each.  The times carry "sockets" where the two ranks
    share one card."""
    import numpy as np
    results, route, wall = launch_ranks(
        torch, "--e14-worker", layers, seed, timeout_s,
        inspect=lambda tmp: [torch.load(os.path.join(tmp, f"dlrm{r}.pt"))
                             for r in range(2)])
    if results is None:
        return False, None
    saved, results = results[-1], results[:-1]
    ok13, e13 = _e13_report(torch, np, results, saved, E13_LAYERS, seed,
                            card, route, wall)
    n = len(results)
    via = "sockets" if "socket" in route else "NCCL"
    ok = True
    # (a) training.
    runs = [res["train"] for res in results]
    for i, steps in enumerate(zip(*(t["steps"] for t in runs))):
        rep_same = len({str(st["rep"]) for st in steps}) == 1
        shards_differ = len({str(st["shards"]) for st in steps}) == n
        losses = [st["loss"] for st in steps]
        same_loss = all(np.isfinite(v) for v in losses) \
            and len(set(losses)) == 1
        launches = all(st["launches"] == [layers] * 3 for st in steps)
        good = rep_same and shards_differ and same_loss and launches
        ok = ok and good
        print(f"e14 (a): step {i + 1}: losses {losses} (bitwise equal "
              f"across ranks: {len(set(losses)) == 1}); replicated leaves "
              f"bitwise equal across ranks: {rep_same}; tp shards differ: "
              f"{shards_differ}; flash launches fwd/dq/dkv "
              f"{[st['launches'] for st in steps]}; step "
              f"{_joined(st['s'] * 1e3 for st in steps)} ms"
              f"{' (with the gradient check)' if i == 0 else ''}; "
              f"{steps[0]['psums']} tp reductions taking "
              f"{_joined(st['psum_ms'] for st in steps)} ms ({via}); peak "
              f"{max(st['peak_gib'] for st in steps):.2f} GiB -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    for res, t in zip(results, runs):
        worst = max(t["grad_err"].values())
        good = worst <= GRAD_TOL
        ok = ok and good
        name = max(t["grad_err"], key=t["grad_err"].get)
        print(f"e14 (a): rank {res['rank']}: step-1 gradients of "
              f"{sum(t['leaves'])} leaves ({t['leaves'][1]} of them tp "
              f"shards, {t['shard_gib']:.2f} GiB) against the tp-off model: "
              f"worst relative norm {worst:.3e} ({name}; tol {GRAD_TOL:g}) "
              f"-> {'PASS' if good else 'FAIL'}", flush=True)
    a = runs[0]["steps"][1:]
    med = sorted(st["s"] for st in a)[len(a) // 2] * 1e3
    red = sorted(st["psum_ms"] for st in a)[len(a) // 2]
    print(f"e14 (a): Llama-3-8B width, {layers} layers, tp = {n}: step "
          f"{med:.1f} ms on rank 0 (the median of steps 2-{E14_STEPS}), the "
          f"tp reductions {red:.1f} ms of it ({via}, CUDA events around "
          f"each), {runs[0]['psum_bytes'] / 1e6:.1f} MB a step and rank "
          f"through them (4 x B x T x d_model x 2 bytes a layer), the "
          f"replicated leaves' allreduce "
          f"{runs[0]['allreduce_bytes'] / 1e9:.3f} GB a step, "
          f"{E14_SEQ / med * 1e3:.1f} tokens/s, peak "
          f"{max(st['peak_gib'] for t in runs for st in t['steps']):.2f} "
          f"GiB a rank, the rank's (a) in {runs[0]['wall']:.1f} s [{card}; "
          f"two ranks on {route}]", flush=True)
    # (b) decode.
    dec = [res["decode"] for res in results]
    for res, d in zip(results, dec):
        worst = max(d["errs"])
        good = worst <= DECODE_TOL and d["kv_heads"][0] == d["kv_heads"][1]
        ok = ok and good
        print(f"e14 (b): rank {res['rank']}: prefill of {E14_PROMPTS} x "
              f"{E14_PROMPT} tokens and {len(d['errs']) - 1} decode steps "
              f"fed the tp-off run's tokens: logits against tp-off, "
              f"relative norm prefill {d['errs'][0]:.3e}, steps up to "
              f"{max(d['errs'][1:]):.3e} (tol {DECODE_TOL:g}); the cache "
              f"holds {d['kv_heads'][0]} kv heads a rank; prefill "
              f"{d['prefill_ms']:.1f} ms, a decode step "
              f"{_joined(d['step_ms'])} ms ({via}); flash launches "
              f"{d['launches']} -> {'PASS' if good else 'FAIL'}", flush=True)
    same = all(d["gen"] == dec[0]["gen"] for d in dec)
    ok = ok and same
    agree = np.mean(np.array(dec[0]["gen"]) == np.array(dec[0]["ref"]))
    print(f"e14 (b): generate of {E14_NEW} greedy tokens at tp = {n}: "
          f"bitwise equal across ranks: {same}; {agree:.0%} of them equal "
          f"to the tp-off run's (bf16 sums in another order may flip a "
          f"near tie) -> {'PASS' if same else 'FAIL'}", flush=True)
    # (c) BERT.
    for res in results:
        b = res["bert"]
        qk = {n: v for n, v in b["grad_err"].items()
              if n.endswith((".wq", ".wk"))}
        rest = {n: v for n, v in b["grad_err"].items() if n not in qk}
        worst = max((v[0], n) for n, v in rest.items())
        worst_qk = max((v[0], n) for n, v in qk.items())
        low_cos = min((v[1], n) for n, v in qk.items())
        good = (b["whole"] <= GRAD_TOL and worst[0] <= GRAD_TOL
                and low_cos[0] >= QK_COS_TOL
                and b["launches"] == [E14_BERT_LAYERS] * 3
                and np.isfinite(b["loss"]))
        ok = ok and good
        print(f"e14 (c): rank {res['rank']}: BERT-Large width, "
              f"{E14_BERT_LAYERS} layers, B={E14_BERT_BATCH} "
              f"T={E14_BERT_SEQ}, {b['heads']} heads a rank (D = 64): loss "
              f"{b['loss']:.6f}; gradients of {sum(b['leaves'])} leaves "
              f"({b['leaves'][1]} tp shards) against tp-off: the whole "
              f"gradient's relative norm {b['whole']:.3e}, worst of the "
              f"{len(rest)} leaves but wq/wk {worst[0]:.3e} ({worst[1]}; tol "
              f"{GRAD_TOL:g}); wq/wk worst relative norm {worst_qk[0]:.3e} "
              f"({worst_qk[1]}), lowest cosine {low_cos[0]:.5f} "
              f"({low_cos[1]}; tol {QK_COS_TOL:g}, E6's rule: sums over "
              f"near-uniform attention rows that cancel, ds rounded to bf16); "
              f"flash launches {b['launches']} -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    print(f"e14: E14 on rank 0 in {results[0]['e14_wall']:.1f} s "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    ok15, flash15 = _e15_report(np, results, card, via, route)
    print(f"e14/e15: two ranks through the launcher in {wall:.1f} s (E15 "
          f"{results[0]['e15_wall']:.1f} s of it on rank 0) -> "
          f"{'PASS' if ok and ok15 else 'FAIL'}", flush=True)
    r0 = results[0]
    flash = [sum(st["launches"][k] for st in r0["train"]["steps"])
             + r0["decode"]["launches"][k] + r0["bert"]["launches"][k]
             for k in range(3)]
    return ok and ok15, dict(flash=flash, flash15=flash15, ok13=ok13,
                             e13=e13, e13_s=results[0]["e13_wall"],
                             e15_s=results[0]["e15_wall"])


def _e15_report(np, results, card, via, route):
    """E15's checks and lines, from the ranks' records of E14's launch:
    (a) every leaf's step-1 gradient (the replicated leaves world-averaged
    under the pp rule, the slabs through ``ShardedParallel``) within
    GRAD_TOL (relative norm) of the matching slab of the pp-off model's;
    the losses finite and bitwise equal across the stages, the replicated
    leaves bitwise equal after every step and the slabs not; the flash
    launches E15_MICRO x (layers a stage) of each kernel a step on each
    rank.  (b) ``last_stage`` with ``remat_stages``: the step-1 gradients
    within GRAD_TOL of (a)'s, the step's peak above its start below (a)'s
    step 1 on each rank, the forward launches twice (a)'s (the stage
    recomputed in the backward) and dq, dk/dv as (a)'s, the losses
    bitwise equal across the stages.  Returns ``(ok, rank 0's launches)``."""
    n = len(results)
    per = E15_MICRO * E15_LAYERS // n
    runs = [res["pp"] for res in results]
    ok = True
    for i, steps in enumerate(zip(*(t["steps"] for t in runs))):
        rep_same = len({str(st["rep"]) for st in steps}) == 1
        slabs_differ = len({str(st["shards"]) for st in steps}) == n
        losses = [st["loss"] for st in steps]
        same_loss = all(np.isfinite(v) for v in losses) \
            and len(set(losses)) == 1
        launches = all(st["launches"] == [per] * 3 for st in steps)
        good = rep_same and slabs_differ and same_loss and launches
        ok = ok and good
        print(f"e15 (a): step {i + 1}: losses {losses} (bitwise equal "
              f"across stages: {len(set(losses)) == 1}); replicated leaves "
              f"bitwise equal across ranks: {rep_same}; slabs differ: "
              f"{slabs_differ}; flash launches fwd/dq/dkv "
              f"{[st['launches'] for st in steps]}; step "
              f"{_joined(st['s'] * 1e3 for st in steps)} ms"
              f"{' (with the gradient check)' if i == 0 else ''}; "
              f"{[st['exchanges'] for st in steps]} pp exchanges taking "
              f"{_joined(st['exchange_ms'] for st in steps)} ms ({via}); "
              f"peak above the step's start "
              f"{_joined((st['peak_gib'] for st in steps), '{:.2f}')} GiB -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    for res, t in zip(results, runs):
        worst = max(t["grad_err"].values())
        good = worst <= GRAD_TOL
        ok = ok and good
        name = max(t["grad_err"], key=t["grad_err"].get)
        print(f"e15 (a): rank {res['rank']} (stage {t['stage']}): step-1 "
              f"gradients of {sum(t['leaves'])} leaves ({t['leaves'][1]} "
              f"of them slab leaves, {t['slab_gib']:.2f} GiB) against the "
              f"pp-off model: worst relative norm {worst:.3e} ({name}; tol "
              f"{GRAD_TOL:g}); embed {t['grad_err']['embed']:.3e}, lm_head "
              f"{t['grad_err']['lm_head']:.3e} -> "
              f"{'PASS' if good else 'FAIL'}", flush=True)
    a = runs[0]["steps"][1:]
    med = sorted(st["s"] for st in a)[len(a) // 2] * 1e3
    exch = sorted(st["exchange_ms"] for st in a)[len(a) // 2]
    steps_label = ("step 2" if E15_STEPS == 2 else
                   f"the median of steps 2-{E15_STEPS}")
    tokens = E15_BATCH * E15_SEQ
    bubble = (n - 1) / (n + E15_MICRO - 1)
    print(f"e15 (a): Llama-3-8B width, {E15_LAYERS} layers over pp = {n} "
          f"({E15_LAYERS // n} a stage), B={E15_BATCH} x T={E15_SEQ}, "
          f"M={E15_MICRO}, bubble (S-1)/(S+M-1) = {bubble:.3f}: step "
          f"{med:.1f} ms on rank 0 ({steps_label}), the "
          f"{a[0]['exchanges']} pp exchanges {exch:.1f} ms of it ({via}, "
          f"CUDA events around each): {E15_MICRO} activation hops of "
          f"{runs[0]['hop_bytes'] / 1e6:.1f} MB each way and the output's "
          f"sum over pp ({runs[0]['psum_bytes'] / 1e6:.1f} MB); "
          f"{tokens / med * 1e3:.1f} tokens/s; peak "
          f"{max(st['total_gib'] for t in runs for st in t['steps']):.2f} "
          f"GiB a rank (allocated), the rank's (a) in {runs[0]['wall']:.1f} s"
          f" [{card}; two ranks on {route}]", flush=True)
    for res, t in zip(results, runs):
        b = res["pp_remat"]
        worst = max(b["grad_err"].values())
        name = max(b["grad_err"], key=b["grad_err"].get)
        peak_a = t["steps"][0]["peak_gib"]
        good = (worst <= GRAD_TOL and b["peak_gib"] < peak_a
                and b["launches"] == [2 * per, per, per]
                and np.isfinite(b["loss"]))
        ok = ok and good
        print(f"e15 (b): rank {res['rank']} (stage {t['stage']}): "
              f"last_stage + remat_stages, one step: loss {b['loss']:.6f}; "
              f"step-1 gradients against (a)'s: worst relative norm "
              f"{worst:.3e} ({name}; tol {GRAD_TOL:g}); peak above the "
              f"step's start {b['peak_gib']:.2f} GiB against (a)'s "
              f"{peak_a:.2f}; flash launches {b['launches']} (the rule: "
              f"forward 2 x M x layers a stage, the stage recomputed in the "
              f"backward; dq, dk/dv M x layers); {b['exchanges']} pp "
              f"exchanges taking {b['exchange_ms']:.1f} ms; the step "
              f"{b['s'] * 1e3:.1f} ms -> {'PASS' if good else 'FAIL'}",
              flush=True)
    same = len({res["pp_remat"]["loss"] for res in results}) == 1
    ok = ok and same
    print(f"e15 (b): losses bitwise equal across the stages (the last "
          f"stage's, by a scalar sum over pp): {same} -> "
          f"{'PASS' if same else 'FAIL'}", flush=True)
    r0 = results[0]
    flash = [sum(st["launches"][k] for st in r0["pp"]["steps"])
             + r0["pp_remat"]["launches"][k] for k in range(3)]
    return ok, flash


E16_LAYERS = 1           # (b): Mistral-7B at full width cut to one layer
E16_REQUESTS = 8         # a serving round: 8 prompts of E16_REQ_PROMPT
E16_REQ_PROMPT = PROMPT_LEN
E16_REQ_NEW = 8
E16_DRAIN = 4            # requests in flight when the drain begins
E16_TIMEOUT_S = 300
E16_ENV = {"HOROVOD_SERVE_MAX_BATCH": str(E16_REQUESTS),
           "HOROVOD_SERVE_BUCKETS": str(E16_REQUESTS),
           "HOROVOD_SERVE_DEADLINE_MS": "120000"}


def _post(port, inputs, timeout=120):
    """One ``POST /v1/infer``: ``(status, outputs or None)``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/infer",
        data=json.dumps({"inputs": inputs}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())["outputs"]
    except urllib.error.HTTPError as exc:
        return exc.code, None


def e16_worker(args):
    """One rank of E16 (b), started by the port's launcher with ``--serve
    --serve-port P``: the worker side of ``--serve`` as the JAX workers
    build it.  ``Config.from_env()`` (``serve``, ``serve_port``, the
    batcher's knobs) -> ``ContinuousBatcher`` -> ``FrontDoor`` on
    ``serve_port + rank`` -> ``Replica.load`` of ``mistral_7b()`` at full
    width, ``--train-layers`` deep, with the rolling cache (rank 0 seeded,
    rank 1 zeros) -> ``serve_loop``.  A round: E16_REQUESTS HTTP requests
    of E16_REQ_PROMPT tokens and E16_REQ_NEW new ones, all queued before the
    loop starts (so both ranks serve one batch of the same rows).  Version
    1, its repeat, a round; version 2, a round; then the drain with
    E16_DRAIN requests in flight and one more after it.  Writes
    ``rank<HOROVOD_RANK>.json`` in ``args.e16_worker``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve import (ContinuousBatcher, FrontDoor,
                                         Replica, parse_buckets)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    cfg = Config.from_env()
    res = dict(rank=r, size=n, serve=cfg.serve, serve_port=cfg.serve_port,
               card=torch.cuda.get_device_name(dev))
    mcfg = tl.mistral_7b(n_layers=args.train_layers, rolling_cache=True)

    def weights(version):
        p = tl.init_params(mcfg, torch.Generator(device=dev).manual_seed(
            args.seed + 30 + version))
        for _, t in tl.named_parameters(p):
            t.requires_grad_(False)
            if r != 0:
                t.zero_()
        return p

    rep = Replica(lambda p, x: tl.generate(p, x, E16_REQ_NEW, mcfg))
    batcher = ContinuousBatcher(
        cfg.serve_max_batch, parse_buckets(cfg.serve_buckets,
                                           cfg.serve_max_batch),
        cfg.serve_deadline_ms, cfg.serve_max_inflight or cfg.max_inflight,
        cfg.serve_queue_depth)
    door = FrontDoor(batcher, port=cfg.serve_port + r).start()
    res["door_port"] = door.port
    prompts = np.random.RandomState(args.seed + 31).randint(
        0, mcfg.vocab_size, (E16_REQUESTS, E16_REQ_PROMPT)).tolist()

    def load(version):
        params = weights(version)
        named = list(tl.named_parameters(params))
        before = _checksum(torch, named)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = rep.load(params, version=version)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for _, t in named)
        return dict(loaded=loaded, before=before, s=secs, bytes=nbytes,
                    after=_checksum(torch, tl.named_parameters(rep.params)))

    def serve(count, then=None):
        """``count`` requests queued, then the loop; ``then()`` runs while
        they wait in the queue."""
        answers = [None] * count
        clients = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, _post(door.port, prompts[i])), daemon=True)
            for i in range(count)]
        for c in clients:
            c.start()
        t_end = time.time() + 60
        while batcher.pending() < count and time.time() < t_end:
            time.sleep(0.005)
        late = then() if then is not None else None
        _zero_flash(fa)
        stop = threading.Event()
        loop = threading.Thread(target=rep.serve_loop, args=(batcher, stop),
                                daemon=True)
        t0 = time.perf_counter()
        loop.start()
        for c in clients:
            c.join(120)
        wall = time.perf_counter() - t0
        stop.set()
        loop.join(60)
        return dict(codes=[a[0] if a else None for a in answers],
                    tokens=[a[1] if a else None for a in answers],
                    wall=wall, late=late,
                    launches=fa.flash_attention_fwd.launches)

    res["v1"] = load(1)
    res["repeat"] = rep.load(weights(1), version=1)
    res["loads_after_repeat"] = rep.loads
    # Warm-up outside the rounds (cuBLAS handles, the allocator, the
    # kernels' first launches), as the serving phase does.
    t0 = time.perf_counter()
    rep.forward(np.asarray(prompts[:1])[:, :64])
    torch.cuda.synchronize()
    res["warmup_s"] = time.perf_counter() - t0
    res["round1"] = serve(E16_REQUESTS)
    res["v2"] = load(2)
    res["round2"] = serve(E16_REQUESTS)

    def drain():
        door.drain()
        return _post(door.port, prompts[0])[0]
    res["drain"] = serve(E16_DRAIN, then=drain)
    res["stats"] = door.stats()
    door.stop()
    hvd.barrier()
    hvd.shutdown()
    _write_result(args.e16_worker, res)
    print(f"e16 rank {r}: done", flush=True)
    return 0


def e16_phase(torch, layers, seed, card, timeout_s=E16_TIMEOUT_S):
    """E16 (b): two ranks under ``python -m horovod_tpu_torch.runner -np 2
    --serve --serve-port P`` (``e16_worker``), Mistral-7B's width at
    ``layers``.  (1) Each rank's Config reads ``serve`` and ``serve_port``
    and its front door listens on P + rank; (2) the v1 fan-out: rank 1
    from zeros to rank 0's checksum, bitwise, and the repeat of v1 no
    broadcast; (3) a round of HTTP requests: all 200, the tokens bitwise
    equal across the ranks; (4) the v2 update re-broadcast without a
    restart, its round all 200 and equal across the ranks; (5) the drain:
    the requests in flight 200, the one after it 503.  Returns (ok,
    dict)."""
    from horovod_tpu_torch.common.net import free_ports
    import socket
    for _ in range(50):
        port, = free_ports(1)
        with socket.socket() as sk:
            try:
                sk.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        break
    results, route, wall = launch_ranks(
        torch, "--e16-worker", layers, seed, timeout_s,
        launcher_flags=("--serve", "--serve-port", str(port)),
        env_extra=E16_ENV)
    if results is None:
        print(f"e16: (b) FAILED ({route}, {wall:.1f} s)", flush=True)
        return False, None
    a, b = results
    checks = []

    def check(what, good):
        checks.append(good)
        print(f"e16: ({len(checks)}) {what} -> {'PASS' if good else 'FAIL'}",
              flush=True)

    check(f"Config.serve {[x['serve'] for x in results]}, serve_port "
          f"{[x['serve_port'] for x in results]} (want {port}), front doors "
          f"on {[x['door_port'] for x in results]}",
          all(x["serve"] and x["serve_port"] == port
              and x["door_port"] == port + x["rank"] for x in results))
    gbps = a["v1"]["bytes"] / a["v1"]["s"] / 1e9
    check(f"v1 fan-out of {a['v1']['bytes'] / 1e9:.3f} GB in "
          f"{a['v1']['s']:.3f} s ({gbps:.3f} GB/s, {route}): rank 1 from "
          f"{b['v1']['before']} to {b['v1']['after']}, rank 0 "
          f"{a['v1']['after']}; the repeat loaded {a['repeat']}/"
          f"{b['repeat']}, loads {a['loads_after_repeat']}/"
          f"{b['loads_after_repeat']}",
          b["v1"]["before"] == [0, 0] and a["v1"]["after"] ==
          b["v1"]["after"] == a["v1"]["before"] and a["v1"]["loaded"]
          and b["v1"]["loaded"] and not a["repeat"] and not b["repeat"]
          and a["loads_after_repeat"] == b["loads_after_repeat"] == 1)
    for k, label in (("round1", "v1"), ("round2", "v2")):
        check(f"{label}: {E16_REQUESTS} HTTP requests of {E16_REQ_PROMPT} "
              f"tokens, {E16_REQ_NEW} new each, a rank: statuses "
              f"{sorted(set(a[k]['codes'] + b[k]['codes']))}, "
              f"{a[k]['wall']:.3f} / {b[k]['wall']:.3f} s, tokens bitwise "
              f"across the ranks: {a[k]['tokens'] == b[k]['tokens']}",
              set(a[k]["codes"] + b[k]["codes"]) == {200}
              and a[k]["tokens"] == b[k]["tokens"]
              and all(len(t) == E16_REQ_NEW for t in a[k]["tokens"]))
    check(f"v2 re-broadcast without a restart in {a['v2']['s']:.3f} s: "
          f"loaded {a['v2']['loaded']}/{b['v2']['loaded']}, checksums equal "
          f"{a['v2']['after'] == b['v2']['after']}, unlike v1's "
          f"{a['v2']['after'] != a['v1']['after']}",
          a["v2"]["loaded"] and b["v2"]["loaded"]
          and a["v2"]["after"] == b["v2"]["after"] != a["v1"]["after"])
    check(f"drain: {E16_DRAIN} requests in flight -> "
          f"{a['drain']['codes']} / {b['drain']['codes']}, one after the "
          f"drain -> {a['drain']['late']} / {b['drain']['late']}",
          set(a["drain"]["codes"] + b["drain"]["codes"]) == {200}
          and a["drain"]["late"] == b["drain"]["late"] == 503)
    print(f"e16: warm-up forward (one 64-token prompt, outside the rounds) "
          f"{a['warmup_s']:.3f} / {b['warmup_s']:.3f} s", flush=True)
    for x in results:
        st = x["stats"]
        print(f"e16: rank {x['rank']}'s front door: p50 "
              f"{st['latency_p50_ms']} ms, p99 {st['latency_p99_ms']} ms, "
              f"{st['responses_ok_total']} ok, {st['responses_error_total']}"
              f" errors, availability {st['availability']}", flush=True)
    launches = sum(a[k]["launches"] for k in ("round1", "round2", "drain"))
    good = launches == 3 * layers
    check(f"flash launches on rank 0 {launches} (want {3 * layers}: a "
          f"prefill batch a round, {layers} layer(s))", good)
    print(f"e16: (b) in {wall:.1f} s, card {card}", flush=True)
    return all(checks), dict(flash=launches, gbps=gbps,
                             p99=[x["stats"]["latency_p99_ms"]
                                  for x in results])


def trace_ab_phase(torch, hvd, grads, iters=5):
    """The size-1 counterpart of the JAX bench's trace A/B: the engine's
    grouped allreduce of the gradient set with the tracer detached (the
    disarmed default) and attached (no file), in turns off, on, on, off,
    each a median of ``iters`` calls; disarmed, no batch may be timed.
    Returns ok."""
    from horovod_tpu_torch.trace import TraceRecorder
    eng = hvd.common.basics._get_state().engine
    dev = hvd.device()
    if eng.tracer is not None:
        print("trace A/B: the engine was started armed; skipped", flush=True)
        return False

    def call():
        hvd.grouped_allreduce(grads, name="trace_ab")
        torch.cuda.synchronize()

    call()
    times = {False: [], True: []}
    timed0 = eng.timed_batches
    disarmed_timed, summary = 0, None
    for armed in (False, True, True, False):
        rec = eng.tracer = TraceRecorder(capacity=4096) if armed else None
        t = eng.timed_batches
        times[armed].append(median_s(torch, call, iters))
        eng.tracer = None
        # A disarmed cycle reads the inline-settled batches' card times.
        hvd.allreduce(torch.zeros(1, device=dev), name="trace_ab.read")
        torch.cuda.synchronize()
        if armed:
            summary = rec.phase_summary()
        else:
            disarmed_timed += eng.timed_batches - t
    off = sum(times[False]) / 2 * 1e3
    on = sum(times[True]) / 2 * 1e3
    ph = (summary or {}).get("phases_us") or {}
    ok = disarmed_timed == 0 and eng.timed_batches > timed0 and bool(ph)
    print(f"trace A/B at size 1: grouped_allreduce of the gradient set "
          f"({_nbytes(grads) / 1e9:.2f} GB, {len(grads)} tensors), "
          f"disarmed {off:.3f} ms, armed {on:.3f} ms ({on / off - 1:+.1%}); "
          f"armed phases (us) "
          + ", ".join(f"{k} {v:.1f}" for k, v in ph.items())
          + f"; batches timed while disarmed {disarmed_timed} -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth at llama3_8b width (default 32)")
    ap.add_argument("--train-layers", type=int, default=4,
                    help="decoder depth of the training phase at llama3_8b "
                         "width (default 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--e3-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase E3
    ap.add_argument("--e6-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase E6
    ap.add_argument("--e7-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase E7
    ap.add_argument("--e8-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase E8
    ap.add_argument("--e9-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of phase E9
    ap.add_argument("--e10-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of E10 (a, b, d)
    ap.add_argument("--e10-tune-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of E10 (c)
    ap.add_argument("--e11-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one worker of E11
    ap.add_argument("--e12-driver", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # E12's elastic driver
    ap.add_argument("--e12-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one worker of E12
    ap.add_argument("--e14-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of E13-E15
    ap.add_argument("--e16-worker", metavar="RESULT_DIR",
                    help=argparse.SUPPRESS)   # one rank of E16 (b)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import native
        from horovod_tpu_torch.models import llama as tl
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import adasum as ak
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fusion
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    if args.e3_worker:
        return e3_worker(args)
    if args.e6_worker:
        return e6_worker(args)
    if args.e7_worker:
        return e7_worker(args)
    if args.e8_worker:
        return e8_worker(args)
    if args.e9_worker:
        return e9_worker(args)
    if args.e10_worker:
        return e10_worker(args)
    if args.e10_tune_worker:
        return e10_tune_worker(args)
    if args.e11_worker:
        return e11_worker(args)
    if args.e12_driver:
        return e12_driver(args)
    if args.e12_worker:
        return e12_worker(args)
    if args.e14_worker:
        return e14_worker(args)
    if args.e16_worker:
        return e16_worker(args)
    tag_run()
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    loading_ok = module_loading_phase()

    t0 = time.time()
    # The coordinator (g++) builds beside the kernels (nvcc, one each).
    coord = threading.Thread(target=native._build)
    coord.start()
    libs = _build.build_all()
    coord.join()
    print(f"build: {sorted(libs)} and the coordinator in "
          f"{time.time() - t0:.1f} s", flush=True)
    spilled = set()
    for name in libs:
        entry = ""
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                # The kernel's name and template arguments out of the
                # mangled name, e.g. flash_fwd_wgmma_kernel<Li128>.
                m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)I(\w+?)EE",
                              line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else line
            elif "registers" in line or "spill" in line:
                print(f"build[{name}]: {entry}: {line.strip()}", flush=True)
                if re.search(r"[1-9]\d* bytes spill", line):
                    spilled.add(name)
    # The fusion kernels are memory bound: a spill would be a second pass.
    no_spills = "fusion" in _build.build_logs and "fusion" not in spilled
    print(f"build: fusion.cu without spills: {no_spills}", flush=True)
    tc_ok = tensor_core_check(_build, libs)

    dev = torch.device("cuda:0")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = flash_phase(torch, fa, dev, args.seed, flush)
    bwd_cases = flash_bwd_phase(torch, fa, dev, args.seed, flush)
    edges_ok = edge_phase(torch, fa, dev, args.seed)
    del flush
    torch.cuda.empty_cache()
    serve_ok, serve_launches, (e16a_ok, e16a_launches) = serving_phase(
        torch, hvd, tl, fa, args.layers, args.seed)
    torch.cuda.empty_cache()
    train_ok, train_launches = training_phase(torch, hvd, tl, fa,
                                              args.train_layers, args.seed)
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    shapes = _grad_shapes(torch, tl, args.train_layers, dev, args.seed + 1)
    grads = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
             for _, shape in shapes]
    fusion_ok, fusion_res = fusion_phase(torch, fusion, grads, dev,
                                         args.seed, flush)
    layout_ok, _ = layout_phase(torch, fusion, grads, dev, args.seed, flush)
    adasum_ok, adasum_res = adasum_phase(torch, ak, shapes, dev, args.seed,
                                         flush)
    del flush
    size1_ok = engine_size1_phase(torch, hvd, tl, fusion, grads,
                                  args.train_layers, args.seed)
    ab_ok = trace_ab_phase(torch, hvd, grads)
    del grads
    torch.cuda.empty_cache()
    t_e3 = time.time()
    launch = e3_e5_launch(torch, E3_LAYERS, args.seed)
    two_ok, two = two_rank_phase(launch, E3_LAYERS)
    four_ok, four = e4_phase(launch, card)
    engine_ok = (loading_ok and fusion_ok and layout_ok and size1_ok
                 and two_ok and four_ok
                 and no_spills)
    sp_ok, sp = e5_phase(launch, E3_LAYERS, card)
    del launch
    print(f"e3-e5: the phase in {time.time() - t_e3:.1f} s (one launch)",
          flush=True)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    resnet_ok, _ = resnet_phase(torch, hvd, fa, args.seed, card, flush)
    del flush
    torch.cuda.empty_cache()
    tf_ok, tf_launches, _ = transformer_phase(torch, hvd, fa, args.seed,
                                              card)
    e6_ok, e6 = e6_phase(torch, args.seed, card)
    models_ok = resnet_ok and tf_ok and e6_ok
    e7_ok, e7 = e7_phase(torch, E7_LAYERS, args.seed, card)
    t_e8 = time.time()
    e8_ok, e8 = e8_phase(torch, E8_LAYERS, args.seed, card)
    e8_ok = e8_ok and ab_ok
    print(f"e8: the phase in {time.time() - t_e8:.1f} s", flush=True)
    t_e9 = time.time()
    e9_ok, e9 = e9_phase(torch, E9_LAYERS, args.seed, card)
    print(f"e9: the phase in {time.time() - t_e9:.1f} s", flush=True)
    t_e10 = time.time()
    e10_ok, e10 = e10_phase(torch, E10_LAYERS, args.seed, card)
    print(f"e10: the phase in {time.time() - t_e10:.1f} s", flush=True)
    # The elastic phases wait on world formations, commits and the policy's
    # clocks far more than on the card, so they run side by side, and
    # E13-E15 follows E11 into E12's idle wait for the scale-in (PERF.md
    # §6 PR 18).
    res = side_by_side("e11-e15", (
        (("e11", e11_phase, torch, E11_LAYERS, args.seed, card),
         ("e13-e15", e14_phase, torch, E14_LAYERS, args.seed, card)),
        (("e12", e12_phase, torch, E12_LAYERS, args.seed, card),
         ("e16b", e16_phase, torch, E16_LAYERS, args.seed, card))))
    (e11_ok, e11), (e12_ok, e12) = res["e11"], res["e12"]
    e16b_ok, e16b = res.get("e16b", (False, None))
    e16_ok = e16a_ok and e16b_ok
    f16 = e16a_launches + (e16b["flash"] if e16b else 0)
    e14_ok, e14 = res["e13-e15"]
    e13_ok, e13 = (e14["ok13"], e14["e13"]) if e14 else (False, None)
    print(f"e13-e15: one launch: E13 {e14['e13_s'] if e14 else 0:.1f} s, "
          f"E15 {e14['e15_s'] if e14 else 0:.1f} s of it on rank 0, the "
          f"DLRM reference after it", flush=True)

    by_name = {c["case"]: c for c in cases}
    fwd, fwd_train = cases[0], by_name[TRAIN_CASE]   # serving, training
    fwd_ring, fwd_uly = by_name[RING_CASE], by_name[ULYSSES_CASE]
    bwd_by_name = {c["case"]: c for c in bwd_cases}
    bwd, bwd_ring = bwd_by_name[TRAIN_CASE], bwd_by_name[RING_CASE]
    bwd_uly = bwd_by_name[ULYSSES_CASE]
    fwd_tp, bwd_tp = by_name[TP_CASE], bwd_by_name[TP_CASE]
    kernels_ok = all(c["ok"] for c in cases + bwd_cases) and edges_ok \
        and tc_ok
    e5 = sp["launches"] if sp else [0, 0, 0]
    # E6: the size-1 models, then BERT on rank 0 of the size-2 run.
    m6 = [a + b for a, b in zip(tf_launches,
                                e6["flash"] if e6 else [0, 0, 0])]
    f8 = e8["flash"] if e8 else [0, 0, 0]
    f9 = e9["flash"] if e9 else [0, 0, 0]
    f10 = e10["flash"] if e10 else [0, 0, 0]
    f11 = e11["flash"] if e11 else [0, 0, 0]
    f12 = e12["flash"] if e12 else [0, 0, 0]
    f13 = e13["flash"] if e13 else [0, 0, 0]
    f14 = e14["flash"] if e14 else [0, 0, 0]
    f15 = e14["flash15"] if e14 else [0, 0, 0]
    launches = {"flash_fwd": serve_launches + train_launches["flash_fwd"]
                + e5[0] + m6[0] + f8[0] + f9[0] + f10[0] + f11[0] + f12[0]
                + f13[0] + f14[0] + f15[0] + f16,
                "flash_bwd_dq": train_launches["flash_bwd_dq"] + e5[1]
                + m6[1] + f8[1] + f9[1] + f10[1] + f11[1] + f12[1] + f13[1]
                + f14[1] + f15[1],
                "flash_bwd_dkv": train_launches["flash_bwd_dkv"] + e5[2]
                + m6[2] + f8[2] + f9[2] + f10[2] + f11[2] + f12[2]
                + f13[2] + f14[2] + f15[2]}
    print(f"launches on the main paths: flash_fwd {serve_launches} serving "
          f"+ {train_launches['flash_fwd']} training + {e5[0]} "
          f"sequence-parallel (E5 rank 0) + {m6[0]} models (E6, rank 0 at "
          f"size 2) + {f8[0]} observability (E8, rank 0) + {f9[0]} ZeRO "
          f"(E9, rank 0) + {f10[0]} data-plane depth (E10, rank 0) + "
          f"{f11[0]} elastic (E11, rank 0 of each generation) + {f12[0]} "
          f"drains and autoscaling (E12, rank 0 of each generation) + "
          f"{f13[0]} expert parallelism (E13, rank 0) + {f14[0]} tensor "
          f"parallelism (E14, rank 0) + {f15[0]} pipeline parallelism "
          f"(E15, rank 0) + {f16} serving surface (E16: (a) "
          f"{e16a_launches}, (b) rank 0 {f16 - e16a_launches}); "
          f"flash_bwd_dq {train_launches['flash_bwd_dq']} + {e5[1]} + "
          f"{m6[1]} + {f8[1]} + {f9[1]} + {f10[1]} + {f11[1]} + {f12[1]} "
          f"+ {f13[1]} + {f14[1]} + {f15[1]}, flash_bwd_dkv "
          f"{train_launches['flash_bwd_dkv']} + "
          f"{e5[2]} + {m6[2]} + {f8[2]} + {f9[2]} + {f10[2]} + {f11[2]} + "
          f"{f12[2]} + {f13[2]} + {f14[2]} + {f15[2]}",
          flush=True)
    src = "horovod_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu",
             replaces="horovod_tpu/ops/flash_attention.py:98",
             design="flash_fwd_wgmma_kernel: wgmma, q resident, 128-row k/v "
                    "tiles through a TMA ring",
             launches=launches["flash_fwd"], max_abs_err=fwd["max_abs_err"],
             ms=fwd["ms"], plain_ms=fwd["plain_ms"],
             bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
             library_ms=fwd["library_ms"], tflops=fwd["tflops"],
             train_ms=fwd_train["ms"], train_plain_ms=fwd_train["plain_ms"],
             train_bound_ms=fwd_train["bound_ms"],
             train_bound_by=fwd_train["bound_by"],
             train_library_ms=fwd_train["library_ms"],
             train_tflops=fwd_train["tflops"], launches_e5=e5[0],
             ring_ms=fwd_ring["ms"], ring_plain_ms=fwd_ring["plain_ms"],
             ring_bound_ms=fwd_ring["bound_ms"],
             ring_bound_by=fwd_ring["bound_by"],
             ring_library_ms=fwd_ring["library_ms"],
             ring_max_abs_err=fwd_ring["max_abs_err"],
             ring_tflops=fwd_ring["tflops"],
             **{f"ulysses_{k}": fwd_uly[k] for k in _CASE_KEYS},
             launches_e6=m6[0], launches_e8=f8[0], launches_e9=f9[0],
             launches_e10=f10[0], launches_e11=f11[0],
             launches_e12=f12[0], launches_e13=f13[0], launches_e14=f14[0],
             launches_e15=f15[0], launches_e16=f16,
             **{f"tp_{k}": fwd_tp[k] for k in _CASE_KEYS},
             **{f"mistral_{k}": by_name[MISTRAL_CASE][k]
                for k in _CASE_KEYS},
             **{f"{m}_{k}": by_name[case][k] for m, case in MODEL_CASES.items()
                for k in _CASE_KEYS}),
    ] + [
        dict(name=f"flash_bwd_{g}", route="cuda", source=src + "flash_bwd.cu",
             replaces=f"horovod_tpu/ops/flash_attention.py:{line}",
             design=design, launches=launches[f"flash_bwd_{g}"],
             max_abs_err=bwd[g]["max_abs_err"], ms=bwd[g]["ms"],
             plain_ms=bwd["plain_ms"], bound_ms=bwd[g]["bound_ms"],
             bound_by=bwd[g]["bound_by"], library_ms=bwd["library_ms"],
             tflops=bwd[g]["tflops"], launches_e5=e5[1 if g == "dq" else 2],
             ring_ms=bwd_ring[g]["ms"], ring_plain_ms=bwd_ring["plain_ms"],
             ring_bound_ms=bwd_ring[g]["bound_ms"],
             ring_bound_by=bwd_ring[g]["bound_by"],
             ring_library_ms=bwd_ring["library_ms"],
             ring_max_abs_err=bwd_ring[g]["max_abs_err"],
             ring_tflops=bwd_ring[g]["tflops"],
             **{f"ulysses_{k}": bwd_uly[g][k] for k in _CASE_KEYS
                if k in bwd_uly[g]},
             ulysses_plain_ms=bwd_uly["plain_ms"],
             ulysses_library_ms=bwd_uly["library_ms"],
             launches_e6=m6[1 if g == "dq" else 2],
             launches_e8=f8[1 if g == "dq" else 2],
             launches_e9=f9[1 if g == "dq" else 2],
             launches_e10=f10[1 if g == "dq" else 2],
             launches_e11=f11[1 if g == "dq" else 2],
             launches_e12=f12[1 if g == "dq" else 2],
             launches_e13=f13[1 if g == "dq" else 2],
             launches_e14=f14[1 if g == "dq" else 2],
             launches_e15=f15[1 if g == "dq" else 2],
             **{f"tp_{k}": bwd_tp[g][k] for k in _CASE_KEYS
                if k in bwd_tp[g]},
             tp_plain_ms=bwd_tp["plain_ms"],
             tp_library_ms=bwd_tp["library_ms"],
             **{f"{m}_{k}": bwd_by_name[case][g][k]
                for m, case in MODEL_CASES.items() for k in _CASE_KEYS
                if k in bwd_by_name[case][g]},
             **{f"{m}_{k}": bwd_by_name[case][k]
                for m, case in MODEL_CASES.items()
                for k in ("plain_ms", "library_ms")})
        for g, line, design in (
            ("dq", 170, "flash_bwd_dq_wgmma_kernel: wgmma, q/do resident, "
                        "64-row k/v tiles through a TMA ring"),
            ("dkv", 221, "flash_bwd_dkv_wgmma_kernel: wgmma, k/v resident, "
                         "64-row q/do tiles through a TMA ring"))]
    for kern, design in (
            ("pack", "hvd_fusion_copy (no factor, no cast; 16-byte aligned "
                     "tensors): a block of one warp a 32 KB chunk, "
                     "cp.async.bulk global -> shared -> global on an "
                     "mbarrier; else a block a 128 KB chunk walking its "
                     "tensors, 16-byte vectors, up to 8 in flight a thread, "
                     "funnel-shift realignment, prescale and wire cast "
                     "(hvd_fusion_pack)"),
            ("unpack", "hvd_fusion_unpack (average, cast back, postscale): "
                       "a block a 128 KB chunk walking its tensors, "
                       "16-byte vectors, up to 8 in flight a thread; the "
                       "byte path (hvd_fusion_copy) as pack's")):
        r = fusion_res[kern]
        kernels.append(dict(
            name=f"fusion_{kern}", route="cuda", source=src + "fusion.cu",
            replaces="horovod_tpu/ops/engine.py:1955 (no Pallas kernel: XLA "
                     "fused this work into _build_fused_reduce)",
            design=design,
            launches=(two[kern] if two else 0) + (four[kern] if four else 0)
            + (e6[kern] if e6 else 0) + (e8[kern] if e8 else 0)
            + (e9[kern] if e9 else 0) + (e10[kern] if e10 else 0)
            + (e11[kern] if e11 else 0) + (e12[kern] if e12 else 0),
            launches_e3=two[kern] if two else 0,
            launches_e4=four[kern] if four else 0,
            launches_e6=e6[kern] if e6 else 0,
            launches_e8=e8[kern] if e8 else 0,
            launches_e9=e9[kern] if e9 else 0,
            launches_e10=e10[kern] if e10 else 0,
            launches_e11=e11[kern] if e11 else 0,
            launches_e12=e12[kern] if e12 else 0,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], gbps=r["gbps"],
            call_ms=r["call_ms"], host_us=r["host_us"]))
    for kern, line, design in (
            ("dots", 34, "hvd_adasum_dots: a grid-stride loop of 16-byte "
                         "loads, float32 sums a thread, warp shuffles, then "
                         "the blocks' partials in block order (no float "
                         "atomics: deterministic)"),
            ("combine", 235, "hvd_adasum_combine: the coefficients from the "
                             "summed triple on the card, a grid-stride loop "
                             "of 16-byte loads and stores, no FMA "
                             "contraction, in place over the kept half")):
        r = adasum_res[kern]
        kernels.append(dict(
            name=f"adasum_{kern}", route="cuda", source=src + "adasum.cu",
            replaces=f"horovod_tpu/parallel/adasum.py:{line} (no Pallas "
                     f"kernel: XLA fused this work into the collective "
                     f"program)",
            design=design, launches=e7[kern] if e7 else 0,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], gbps=r["gbps"], n=r["n"]))
    for kern in kernels:
        kern["pass"] = (kernels_ok and engine_ok and sp_ok and models_ok
                        and adasum_ok and e7_ok and e8_ok and e9_ok
                        and e10_ok and e11_ok and e12_ok and e13_ok
                        and e14_ok and e16_ok and kern["launches"] > 0)
    stop_strays("chip_smoke")
    print(f"chip_smoke: every phase in {time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    hvd.shutdown()
    if not (kernels_ok and serve_ok and train_ok and engine_ok and sp_ok
            and models_ok and adasum_ok and e7_ok and e8_ok and e9_ok
            and e10_ok and e11_ok and e12_ok and e13_ok and e14_ok
            and e16_ok and all(k["pass"] for k in kernels)):
        _fail(f"kernels ok={kernels_ok} (tile edges {edges_ok}, tensor "
              f"cores {tc_ok}), serving ok={serve_ok}, training ok={train_ok}"
              f", engine ok={engine_ok} (module loading {loading_ok}, "
              f"fusion kernels {fusion_ok}, "
              f"layouts and casts {layout_ok}, size 1 {size1_ok}, two ranks "
              f"{two_ok}, collectives on two ranks {four_ok}), sequence "
              f"parallel ok={sp_ok}, models ok={models_ok} (resnet50 "
              f"{resnet_ok}, transformers {tf_ok}, two ranks {e6_ok}), "
              f"adasum kernels ok={adasum_ok}, four ranks (E7) ok={e7_ok}, "
              f"observability (E8, trace A/B {ab_ok}) ok={e8_ok}, ZeRO (E9) "
              f"ok={e9_ok}, data-plane depth (E10) ok={e10_ok}, elastic "
              f"(E11) ok={e11_ok}, drains and autoscaling (E12) "
              f"ok={e12_ok}, expert parallelism (E13) ok={e13_ok}, tensor "
              f"and pipeline parallelism (E14, E15) ok={e14_ok}, serving "
              f"surface (E16) ok={e16_ok} ((a) {e16a_ok}, (b) {e16b_ok})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
