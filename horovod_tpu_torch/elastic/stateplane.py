# Copied from horovod_tpu/elastic/stateplane.py:1-1025, with torch tensors in
# encode_state/decode_state (:127-170: a new kind tag; numpy state encodes to
# the JAX package's bytes), the blob digest computed once a commit and the
# shard digest a chunk at a time (_WriteJob, :240-366), and fetch_shard
# (:492-515) receiving into one preallocated buffer with a timeout that
# grows with the shard; no blob is digested twice (a one-way fetch is served
# with the commit's digest, a restore keeps the digest it verified).
"""Resilient state plane: overlap-scheduled sharded checkpoints +
peer-to-peer elastic restore (no jax imports).

The ROADMAP's sharded-state item, robustness half: durability and
recovery stop stealing step time by treating checkpoint I/O as just
another scheduled tensor stream, and by restoring re-joiners from the
survivors' memory instead of from disk.

**Overlap-scheduled sharded checkpoints.**  On ``state.commit()`` (paced
by the driver's COMMIT pings — ``state.should_commit()``) each rank
serializes the committed state once and takes its **1/N shard** of the
byte stream — the same pad-to-multiple + even-slice math
``parallel/zero.py`` uses for optimizer-state shards, applied to the
serialized blob — so fleet-wide checkpoint bytes are written once, not N
times.  The durable write is CHUNKED and streamed through the engine's
priority dispatch backlog (PR 7) in a new lowest-priority ``checkpoint``
lane (:data:`~..ops.scheduler.CKPT_LANE`): gradient batches always
dispatch first, the fused-lane budget never counts a checkpoint chunk
(the pure-function budget rule is unchanged), and a bounded number of
chunks ride each cycle's tail.  Durability is two-phase per artifact —
write ``<file>.tmp`` → flush+fsync → atomic rename — and the per-rank
shard manifest is renamed LAST, so a torn or partial checkpoint is never
observable: an epoch exists exactly when every rank's manifest does.
Chunk writes retry with backoff (:func:`~..common.net.retry_with_backoff`)
and a persistent write failure abandons the epoch with attribution — the
previous durable epoch remains the restore point.

**Peer-to-peer elastic restore.**  Every committed epoch is also held in
memory and served by a tiny per-rank :class:`ShardServer`.  On
re-rendezvous a joining rank declares its state epoch in the rendezvous
metadata (``elastic/rendezvous.py`` state records) and, when survivors
hold a NEWER epoch, restores by fetching 1/K shards from the K reachable
survivors (each holds the full committed blob, so any survivor can serve
any shard — a dead peer mid-restore just moves its shard to the next
one) and verifying the reassembled blob against the survivors' digest —
**zero disk reads**.  Disk (the manifest, newest complete epoch wins;
corrupt shards quarantined with rank attribution) is the fallback when
no quorum of newer-epoch survivors exists.

Fault points (``HVD_TPU_FAULT`` — :mod:`horovod_tpu.testing.faults`):
``ckpt_write_fail`` (each shard-chunk write attempt), ``ckpt_torn``
(between the shard rename and the manifest rename — a crash here leaves
a torn epoch that restore must skip), ``restore_peer_exit`` (a survivor
about to serve a shard — ``econnreset``/``crash`` model a peer dying
mid-restore).

**Trust model** (same as the rest of the control plane): the rendezvous
KV, the shard servers and the coordinator sockets are unauthenticated,
and restored state decodes through pickle for non-array values —
exactly like the existing ``broadcast_object``/``state.sync()`` wire.
Everything here assumes the fleet-private network the launcher runs on;
never expose the rendezvous or shard ports beyond it.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import re
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.net import retry_with_backoff
from ..utils.logging import get_logger

log = get_logger()

# A peer fetch's wait: FETCH_TIMEOUT_S plus the piece's bytes at
# FETCH_MIN_RATE bytes/s (the donor digests its piece before its header,
# and a one-way fetch of a few GB takes seconds to send).
FETCH_TIMEOUT_S = 5.0
FETCH_MIN_RATE = 50e6

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
_SHARD_RE = re.compile(r"^shard_(\d+)_of_(\d+)\.json$")

# Serialized-blob framing: numpy arrays go through np.save (portable,
# version-stable), everything else through pickle — one length-prefixed
# record per state key.
_MAGIC = b"HVSP1\n"


# ------------------------------------------------------------- shard math
def shard_bounds(total: int, world: int) -> Tuple[int, int]:
    """``(per, pad)`` for an even 1/world byte split: the blob is padded
    to a multiple of ``world`` and sliced evenly — the byte-stream
    analogue of ``parallel/zero.py``'s ``_shard_leaf`` pad-to-multiple +
    ``psum_scatter`` slice convention, so every rank derives identical
    shard boundaries from (total, world) alone."""
    world = max(1, int(world))
    pad = (-total) % world
    return (total + pad) // world, pad


def shard_of(blob: bytes, index: int, world: int) -> bytes:
    """Shard ``index`` of ``world`` (zero-padded tail, like zero.py's
    padded last shard)."""
    per, pad = shard_bounds(len(blob), world)
    start = index * per
    piece = blob[start:start + per]
    if len(piece) < per:
        piece = piece + b"\x00" * (per - len(piece))
    return piece


def shard_slice_array(arr, rank: int, world: int):
    """Rank's 1/world slice of a flattened numpy array under the SAME
    pad+slice convention as the byte shards above (and zero.py's leaf
    shards): pad with zeros to a multiple of ``world``, slice evenly.
    jax-free — the churn harness asserts a re-joiner's recovered
    optimizer slice with it, and it is pinned equal to
    ``parallel/zero.py``'s device-side slicing by the unit tier."""
    import numpy as np
    flat = np.asarray(arr).reshape(-1)
    per, pad = shard_bounds(flat.size, world)
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    r = max(0, int(rank))
    return flat[r * per:(r + 1) * per]


def blob_digest(blob: bytes) -> str:
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


# ----------------------------------------------------------- serialization
# A value holding torch tensors (a tensor, or a dict/list/tuple of them at
# any depth) is written under its own kind: the structure pickled with each
# tensor replaced by a {_TENSOR: i, "dtype", "shape"} record, then every
# tensor's raw bytes in order.  No dtype passes through numpy, so bfloat16
# needs no ml_dtypes, and the bytes are the tensor's own.
_TENSOR = "__hvd_tensor__"


def _is_tensor(v) -> bool:
    import sys
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _holds_tensor(v) -> bool:
    if _is_tensor(v):
        return True
    if isinstance(v, dict):
        return any(_holds_tensor(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_holds_tensor(x) for x in v)
    return False


def _tensor_parts(v) -> Tuple[bytes, List]:
    """``(header, raw parts)`` of a tensor-holding value: the pickled
    skeleton with its length, and each tensor's bytes (host memory views,
    no copy for a contiguous CPU tensor)."""
    import torch
    raws: List = []

    def strip(x):
        if _is_tensor(x):
            t = x.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            t = t.contiguous().reshape(-1)
            rec = {_TENSOR: len(raws), "dtype": str(t.dtype).split(".")[-1],
                   "shape": list(x.shape)}
            raws.append(memoryview(t.view(torch.uint8).numpy()) if t.numel()
                        else b"")
            return rec
        if isinstance(x, dict):
            return {k: strip(y) for k, y in x.items()}
        if isinstance(x, list):
            return [strip(y) for y in x]
        if isinstance(x, tuple):
            return tuple(strip(y) for y in x)
        return x

    skel = pickle.dumps(strip(v), protocol=4)
    head = struct.pack("<Q", len(skel)) + skel
    for r in raws:
        head += struct.pack("<Q", len(r))
    return head, raws


def _tensors_from(payload) -> object:
    """The value ``_tensor_parts`` wrote: tensors over the payload's
    memory (read-only views; load them with ``copy_``)."""
    import warnings

    import torch
    mv = memoryview(payload)
    (slen,) = struct.unpack("<Q", mv[:8])
    skel = pickle.loads(mv[8:8 + slen])
    off = 8 + slen
    sizes: List[int] = []

    def count(x):
        if isinstance(x, dict):
            if _TENSOR in x:
                sizes.append(0)
                return
            for y in x.values():
                count(y)
        elif isinstance(x, (list, tuple)):
            for y in x:
                count(y)

    count(skel)
    for i in range(len(sizes)):
        (sizes[i],) = struct.unpack("<Q", mv[off:off + 8])
        off += 8
    starts = []
    for n in sizes:
        starts.append(off)
        off += n

    def build(x):
        if isinstance(x, dict):
            if _TENSOR in x:
                i = x[_TENSOR]
                dt = getattr(torch, x["dtype"])
                if sizes[i] == 0:
                    return torch.empty(x["shape"], dtype=dt)
                with warnings.catch_warnings():
                    # A bytes blob is read-only; the tensors are only read.
                    warnings.simplefilter("ignore", UserWarning)
                    raw = torch.frombuffer(mv[starts[i]:starts[i] + sizes[i]],
                                           dtype=torch.uint8)
                return raw.view(dt).reshape(x["shape"])
            return {k: build(y) for k, y in x.items()}
        if isinstance(x, list):
            return [build(y) for y in x]
        if isinstance(x, tuple):
            return tuple(build(y) for y in x)
        return x

    return build(skel)


def encode_state(state: Dict) -> bytes:
    """Serialize a committed state dict (numpy arrays, torch tensors and
    containers of them, picklable scalars/objects) to one deterministic
    byte blob.  A dict of numpy arrays and picklables encodes to the JAX
    package's bytes."""
    import numpy as np
    parts: List = [_MAGIC]
    for k in sorted(state):
        v = state[k]
        raws: List = []
        if isinstance(v, np.ndarray):
            kind = b"N"
            buf = io.BytesIO()
            np.save(buf, v, allow_pickle=False)
            payload = buf.getvalue()
            plen = len(payload)
        elif _holds_tensor(v):
            kind = b"T"
            payload, raws = _tensor_parts(v)
            plen = len(payload) + sum(len(r) for r in raws)
        else:
            kind = b"P"
            payload = pickle.dumps(v, protocol=4)
            plen = len(payload)
        key = k.encode()
        parts.append(struct.pack("<I", len(key)) + key)
        parts.append(kind + struct.pack("<Q", plen))
        parts.append(payload)
        parts.extend(raws)
    return b"".join(parts)


def decode_state(blob: bytes) -> Dict:
    import numpy as np
    mv = memoryview(blob)
    if bytes(mv[:len(_MAGIC)]) != _MAGIC:
        raise ValueError("state plane: bad blob magic (corrupt or foreign)")
    off = len(_MAGIC)
    out: Dict = {}
    while off < len(mv):
        (klen,) = struct.unpack("<I", mv[off:off + 4])
        off += 4
        key = bytes(mv[off:off + klen]).decode()
        off += klen
        kind = bytes(mv[off:off + 1])
        (plen,) = struct.unpack("<Q", mv[off + 1:off + 9])
        off += 9
        payload = mv[off:off + plen]
        off += plen
        if kind == b"N":
            out[key] = np.load(io.BytesIO(payload), allow_pickle=False)
        elif kind == b"T":
            out[key] = _tensors_from(payload)
        else:
            out[key] = pickle.loads(payload)
    return out


# --------------------------------------------------------------- manifests
def _epoch_dir(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"epoch_{epoch:010d}")


def _shard_base(rank: int, world: int) -> str:
    return f"shard_{rank}_of_{world}"


def _fsync_write(path: str, data: bytes) -> None:
    """Two-phase file write: ``path.tmp`` → flush + fsync → rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def list_epochs(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _EPOCH_RE.match(d)))


def epoch_manifests(directory: str, epoch: int) -> Optional[List[dict]]:
    """The epoch's per-rank manifests when the epoch is COMPLETE (every
    rank's manifest present, parseable, mutually consistent), else None.
    A torn manifest — the ``.tmp`` that a crash between the shard rename
    and the manifest rename leaves behind, or an unparseable file — makes
    the epoch incomplete: it is skipped, never loaded."""
    d = _epoch_dir(directory, epoch)
    if not os.path.isdir(d):
        return None
    manifests: Dict[int, dict] = {}
    world = None
    for name in os.listdir(d):
        m = _SHARD_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(d, name)) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            return None                      # torn manifest: epoch unusable
        r, w = int(m.group(1)), int(m.group(2))
        if rec.get("rank") != r or rec.get("world") != w:
            return None
        if world is None:
            world = w
        elif world != w:
            return None                      # mixed-world write: unusable
        manifests[r] = rec
    if world is None or set(manifests) != set(range(world)):
        return None
    return [manifests[r] for r in range(world)]


def latest_complete_epoch(directory: str) -> Optional[int]:
    """Newest epoch whose every shard manifest is present and valid —
    'newest complete epoch wins'."""
    for epoch in reversed(list_epochs(directory)):
        if epoch_manifests(directory, epoch) is not None:
            return epoch
    return None


# --------------------------------------------------------------- write job
class _WriteJob:
    """One epoch's durable write: this rank's shard, chunked, two-phase.

    Chunks run on the engine's checkpoint lane (or inline when no engine
    is attached); the LAST chunk finalizes — shard fsync+rename, then the
    manifest fsync+rename (the commit point).  Superseding commits cancel
    unfinished jobs (newest epoch wins; fast commit cadence must not pile
    up a backlog of doomed epochs)."""

    def __init__(self, plane: "StatePlane", epoch: int, blob: bytes,
                 digest: Optional[str] = None):
        self.plane = plane
        self.epoch = epoch
        # Snapshot the rank/world/generation the job was cut for: an
        # elastic re-bind (obtain() renumbering the plane mid-job) must
        # not make _finalize write a manifest whose rank/world disagree
        # with the shard filename — epoch_manifests would reject it and
        # the epoch would stay incomplete forever.
        self.rank = plane.rank
        self.world = plane.world
        self.generation = plane.generation
        self.shard = shard_of(blob, self.rank, self.world)
        self.total = len(blob)
        # The commit's digest of the blob (one pass over it a commit); the
        # shard's is taken chunk by chunk as the lane writes them, off the
        # committing thread.
        self.blob_digest = digest or blob_digest(blob)
        self._hasher = hashlib.blake2b(digest_size=16)
        self._hashed = 0
        self.canceled = False
        self.failed: Optional[BaseException] = None
        self.done = False
        self._fh = None
        base = _shard_base(self.rank, self.world)
        self._dir = _epoch_dir(plane.directory, epoch)
        self._bin = os.path.join(self._dir, base + ".bin")
        self._man = os.path.join(self._dir, base + ".json")

    def chunk_items(self, chunk_bytes: int) -> List:
        from ..ops.scheduler import CheckpointChunk
        n = len(self.shard)
        chunk_bytes = max(1, int(chunk_bytes))
        offs = list(range(0, n, chunk_bytes)) or [0]
        items = []
        for i, off in enumerate(offs):
            final = i == len(offs) - 1
            items.append(CheckpointChunk(
                name=f"ckpt.e{self.epoch}.r{self.rank}"
                     f".c{i}/{len(offs)}",
                run=(lambda off=off, final=final:
                     self._run_chunk(off, chunk_bytes, final)),
                fail=self.abort))
        return items

    # The chunk body is deliberately small: one bounded write per lane
    # dispatch, so a cycle's checkpoint tail costs microseconds and the
    # stream overlaps training instead of stalling a cycle.
    def _run_chunk(self, off: int, size: int, final: bool) -> None:
        if self.canceled or self.failed is not None:
            self._cleanup()
            return
        try:
            retry_with_backoff(
                lambda: self._write(off, size),
                retries=self.plane.io_retries,
                base_ms=self.plane.io_backoff_ms, max_ms=2000.0)
            self.plane.chunks_written += 1
            if final:
                self._finalize()
        except OSError as exc:
            self.failed = exc
            self._cleanup()
            self.plane._job_failed(self, exc)

    def _write(self, off: int, size: int) -> None:
        fire = self.plane._fire
        if fire is not None:
            fire("ckpt_write_fail", self.rank)
        if self._fh is None:
            os.makedirs(self._dir, exist_ok=True)
            self._fh = open(self._bin + ".tmp", "wb")
        self._fh.seek(off)
        piece = memoryview(self.shard)[off:off + size]
        self._fh.write(piece)
        if off == self._hashed:
            # Chunks run in order; a retried chunk is hashed once.
            self._hasher.update(piece)
            self._hashed += len(piece)

    @property
    def shard_digest(self) -> str:
        if self._hashed != len(self.shard):
            return blob_digest(self.shard)
        return self._hasher.hexdigest()

    def _finalize(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            fh.flush()
            os.fsync(fh.fileno())
            fh.close()
        os.replace(self._bin + ".tmp", self._bin)
        # The torn-checkpoint window: the shard landed but the manifest —
        # the commit point — has not.  A crash here leaves a .tmp (or
        # nothing), so the epoch stays incomplete and restore skips it.
        fire = self.plane._fire
        if fire is not None:
            fire("ckpt_torn", self.rank)
        _fsync_write(self._man, json.dumps({
            "epoch": self.epoch, "generation": self.generation,
            "rank": self.rank, "world": self.world,
            "nbytes": len(self.shard), "total": self.total,
            "digest": self.shard_digest, "blob_digest": self.blob_digest,
            "ts": round(time.time(), 3),
        }).encode())
        self.done = True
        self.plane._job_durable(self)

    def cancel(self) -> None:
        self.canceled = True

    def abort(self, exc: BaseException) -> None:
        """Engine-abort path (the lane is draining on a fault): the epoch
        is abandoned, the previous durable epoch remains."""
        if self.done or self.failed is not None:
            return
        self.failed = exc
        self._cleanup()
        self.plane._job_failed(self, exc)

    def _cleanup(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        for path in (self._bin + ".tmp", self._man + ".tmp"):
            try:
                os.unlink(path)
            except OSError:
                pass


# -------------------------------------------------------------- shard serve
class ShardServer:
    """Tiny per-rank TCP service for peer-to-peer restore.

    One request per connection, newline-framed header, binary payload::

        EPOCH\\n                      -> EPOCH <epoch> <total> <digest>\\n
        SHARD <epoch> <i> <k>\\n      -> OK <nbytes> <digest>\\n<payload>
                                         (shard i of a k-way split of the
                                         in-memory blob) or ERR <why>\\n

    The split factor ``k`` is the REQUESTER's choice: every serving rank
    holds the full committed blob, so a joiner fetches 1/K from each of
    its K reachable survivors (and re-fetches a dead peer's shard from
    any other — the quorum is "at least one reachable newer-epoch
    survivor", because any one can serve everything)."""

    def __init__(self, plane: "StatePlane", addr: str = "0.0.0.0"):
        self.plane = plane
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((addr, 0))
        self._sock.listen(16)
        self.served = 0
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="hvd-tpu-shard-server")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.settimeout(5.0)
                self._handle(conn)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn: socket.socket) -> None:
        line = conn.makefile("rb").readline().decode().strip()
        epoch, blob, digest = self.plane.memory_state()
        if line == "EPOCH":
            total = len(blob) if blob is not None else 0
            conn.sendall(f"EPOCH {epoch} {total} {digest or '-'}\n".encode())
            return
        parts = line.split()
        if len(parts) != 4 or parts[0] != "SHARD":
            conn.sendall(b"ERR bad request\n")
            return
        want_epoch, index, count = (int(parts[1]), int(parts[2]),
                                    int(parts[3]))
        # The plane retains the PREVIOUS committed epoch beside the
        # current one: a survivor committing mid-way through a joiner's
        # multi-shard fetch must keep serving the epoch the fetch
        # started on, or every donor would go "stale" at once and the
        # peer path would silently degrade to disk under active
        # training.
        blob = self.plane.blob_for(want_epoch)
        if blob is None:
            conn.sendall(f"ERR stale epoch (have {epoch})\n".encode())
            return
        if count == 1:
            # The whole blob: no copy, and the commit's digest of it.
            piece, pdigest = blob, self.plane.digest_for(want_epoch)
        else:
            piece = shard_of(blob, index, count)
            pdigest = blob_digest(piece)
        conn.sendall(f"OK {len(piece)} {pdigest}\n".encode())
        # The peer-death-mid-restore fault point: the header is out, the
        # payload is not — exactly the torn-transfer shape a crashing
        # survivor produces.  econnreset severs this connection; crash
        # kills the whole serving process.
        fire = self.plane._fire
        if fire is not None:
            fire("restore_peer_exit", self.plane.rank,
                 sever=lambda: conn.shutdown(socket.SHUT_RDWR))
        conn.sendall(piece)
        self.served += 1

    def stop(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ peer clients
def _ask(addr: str, port: int, request: str,
         timeout: float = 3.0) -> Tuple[str, socket.socket]:
    s = socket.create_connection((addr, port), timeout=timeout)
    s.settimeout(timeout)
    s.sendall(request.encode())
    head = b""
    while not head.endswith(b"\n"):
        c = s.recv(1)
        if not c:
            raise OSError("peer closed before header")
        head += c
    return head.decode().strip(), s


def peer_epoch(addr: str, port: int,
               timeout: float = 3.0) -> Tuple[int, int, str]:
    """``(epoch, total, digest)`` of the peer's in-memory commit."""
    head, s = _ask(addr, port, "EPOCH\n", timeout)
    s.close()
    parts = head.split()
    if len(parts) != 4 or parts[0] != "EPOCH":
        raise OSError(f"bad EPOCH response {head!r}")
    try:
        return int(parts[1]), int(parts[2]), parts[3]
    except ValueError as exc:
        # A reused port (another service answered) or a dying peer's
        # garbled header must take the same failover path as a refused
        # connection — the restore's OSError handling, never a crash.
        raise OSError(f"bad EPOCH response {head!r}") from exc


def fetch_shard(addr: str, port: int, epoch: int, index: int, count: int,
                timeout: float = 5.0, expect: Optional[str] = None) -> bytes:
    """Shard ``index`` of ``count`` of the peer's epoch, verified against
    the digest the peer sends, which must be ``expect`` where given.
    ``timeout`` bounds the connect and each wait, the header's too (a peer
    digests its piece before the header)."""
    head, s = _ask(addr, port, f"SHARD {epoch} {index} {count}\n", timeout)
    try:
        parts = head.split()
        if len(parts) != 3 or parts[0] != "OK":
            raise OSError(f"peer refused shard: {head!r}")
        try:
            n = int(parts[1])
        except ValueError as exc:
            raise OSError(f"malformed shard header {head!r}") from exc
        digest = parts[2]
        if expect is not None and digest != expect:
            raise OSError(f"peer's shard digest {digest} is not the "
                          f"epoch's {expect}")
        data = bytearray(n)
        view, got = memoryview(data), 0
        while got < n:
            c = s.recv_into(view[got:], min(n - got, 1 << 20))
            if not c:
                raise OSError(f"peer died mid-shard ({got}/{n} bytes)")
            got += c
        data = bytes(data)
        if blob_digest(data) != digest:
            raise OSError("shard digest mismatch over the wire")
        return data
    finally:
        s.close()


# --------------------------------------------------------------- the plane
class StatePlane:
    """Per-rank resilient-state agent: in-memory committed epoch +
    overlap-scheduled durable shard writes + the peer/disk restore
    decision.  jax-free; thread-safe (commit from the train thread,
    chunk items from the engine cycle thread, shard serving from the
    server thread)."""

    def __init__(self, directory: str, rank: int = 0, world: int = 1,
                 engine=None, chunk_bytes: int = 1 << 20,
                 generation: int = 0, serve: bool = True,
                 declare: Optional[Callable[[dict], None]] = None,
                 io_retries: int = 3, io_backoff_ms: float = 50.0):
        self.directory = directory
        self.rank = max(0, int(rank))
        self.world = max(1, int(world))
        self.engine = engine
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.generation = int(generation)
        self.io_retries = max(0, int(io_retries))
        self.io_backoff_ms = float(io_backoff_ms)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._mem_epoch = -1
        self._mem_blob: Optional[bytes] = None
        self._mem_digest: Optional[str] = None
        # Current + previous committed blobs (epoch -> blob) and their
        # digests: the shard server answers requests for EITHER, so a
        # commit landing while a joiner fetches does not strand the fetch
        # (see ShardServer._handle).
        self._mem_blobs: Dict[int, bytes] = {}
        self._mem_digests: Dict[int, str] = {}
        self._durable_epoch = -1
        self._job: Optional[_WriteJob] = None
        self._declare = declare
        self._declaring = False          # one declare worker in flight
        self._declare_dirty = False      # re-declare after it returns
        self._last_commit_ts: Optional[float] = None   # monotonic
        # Observability (monitor checkpoint block + tests).
        self.commits = 0
        self.chunks_written = 0
        self.write_failures = 0
        self.disk_reads = 0          # shard FILES opened by restore
        self.peer_shards_fetched = 0
        self.restore_fallbacks = 0   # peer restores that fell back to disk
        self.last_restore_source: Optional[str] = None
        self.quarantined: List[str] = []
        # Fault harness: cached only when armed (zero-cost unarmed, the
        # same contract the controller keeps).
        from ..testing import faults as _faults
        self._fire = _faults.fire if _faults.armed() else None
        self.server = ShardServer(self) if serve else None

    # ------------------------------------------------------------- commits
    def commit(self, state: Optional[Dict] = None,
               blob: Optional[bytes] = None, epoch: Optional[int] = None,
               wait: bool = False, timeout: float = 30.0) -> int:
        """Commit one epoch: publish it in memory (survivors serve it to
        re-joiners immediately) and stream the 1/N durable shard through
        the engine's checkpoint lane (inline when no engine is attached).
        Returns the epoch id."""
        if blob is None:
            if state is None:
                raise ValueError("commit needs a state dict or a blob")
            blob = encode_state(state)
        digest = blob_digest(blob)
        with self._lock:
            if epoch is None:
                epoch = max(self._mem_epoch, self._durable_epoch) + 1
            self._mem_epoch = int(epoch)
            self._mem_blob = blob
            self._mem_digest = digest
            self._remember(int(epoch), blob, digest)
            self._last_commit_ts = time.monotonic()
            self.commits += 1
            prev, self._job = self._job, None
            job = _WriteJob(self, int(epoch), blob, digest)
            self._job = job
        if prev is not None and not prev.done:
            # Newest epoch wins: a fast commit cadence (autoscale
            # oscillation) must not queue a backlog of doomed epochs.
            prev.cancel()
        items = job.chunk_items(self.chunk_bytes)
        eng = self.engine
        submit = getattr(eng, "submit_checkpoint_io", None) if eng else None
        if submit is not None:
            submit(items)
        else:
            for it in items:
                it.run()
        self.declare_async()
        if wait:
            self.wait_durable(int(epoch), timeout)
        return int(epoch)

    def declare_async(self) -> None:
        """Publish this rank's state record to the rendezvous KV off the
        calling (training) thread: the declare is advisory metadata over
        HTTP, and an unreachable driver — exactly the churn this
        subsystem exists for — must not turn every commit into a
        connect-timeout stall.  Latest-wins: at most one worker in
        flight, a commit landing meanwhile re-declares once more."""
        if self._declare is None:
            return
        with self._lock:
            if self._declaring:
                self._declare_dirty = True
                return
            self._declaring = True

        def _run():
            while True:
                try:
                    self._declare(self.describe())
                except Exception as exc:  # noqa: BLE001 - advisory
                    log.warning("state plane: declare failed: %s", exc)
                with self._lock:
                    if self._declare_dirty:
                        self._declare_dirty = False
                        continue
                    self._declaring = False
                    return

        threading.Thread(target=_run, daemon=True,
                         name="hvd-tpu-state-declare").start()

    def wait_durable(self, epoch: int, timeout: float = 30.0) -> bool:
        """Block until ``epoch`` (or newer) is durable on disk; False on
        timeout or if the epoch's write failed/was superseded-then-failed."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._durable_epoch < epoch:
                job = self._job
                if job is not None and job.epoch >= epoch and (
                        job.failed is not None or job.canceled):
                    return False
                if job is None or job.epoch < epoch:
                    # No write in flight can ever reach this epoch.
                    if self._durable_epoch < epoch:
                        return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(0.2, left))
            return True

    def _job_durable(self, job: _WriteJob) -> None:
        with self._cv:
            if job.epoch > self._durable_epoch:
                self._durable_epoch = job.epoch
            if self._job is job:
                self._job = None
            self._cv.notify_all()

    def _job_failed(self, job: _WriteJob, exc: BaseException) -> None:
        with self._cv:
            self.write_failures += 1
            if self._job is job:
                self._job = None
            self._cv.notify_all()
        log.error(
            "state plane: abandoning checkpoint epoch %d on rank %d "
            "(shard write failed after %d retries: %s); durable state "
            "remains epoch %d", job.epoch, self.rank, self.io_retries,
            exc, self._durable_epoch)

    # -------------------------------------------------------------- reading
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._mem_epoch

    @property
    def durable_epoch(self) -> int:
        with self._lock:
            return self._durable_epoch

    def memory_state(self) -> Tuple[int, Optional[bytes], Optional[str]]:
        with self._lock:
            return self._mem_epoch, self._mem_blob, self._mem_digest

    def _remember(self, epoch: int, blob: bytes, digest: str) -> None:
        """Hold ``epoch``'s blob and digest, the current and the previous
        epoch's only.  Called with the lock held."""
        self._mem_blobs[epoch] = blob
        self._mem_digests[epoch] = digest
        for old in sorted(self._mem_blobs)[:-2]:
            del self._mem_blobs[old]
            self._mem_digests.pop(old, None)

    def digest_for(self, epoch: int) -> Optional[str]:
        with self._lock:
            return self._mem_digests.get(int(epoch))

    def blob_for(self, epoch: int) -> Optional[bytes]:
        """The committed blob for ``epoch`` — current or the retained
        previous one (the mid-fetch-commit guarantee), else None."""
        with self._lock:
            return self._mem_blobs.get(int(epoch))

    def describe(self) -> dict:
        """The rendezvous state record a rank declares: epoch + where its
        shard server listens + the blob identity a joiner verifies
        against."""
        with self._lock:
            return {
                "epoch": self._mem_epoch,
                "durable_epoch": self._durable_epoch,
                "generation": self.generation,
                "port": self.server.port if self.server else 0,
                "digest": self._mem_digest,
                "total": len(self._mem_blob) if self._mem_blob else 0,
            }

    def status(self) -> dict:
        """The monitor's ``checkpoint`` block (snapshot + /health)."""
        with self._lock:
            age = (round(time.monotonic() - self._last_commit_ts, 3)
                   if self._last_commit_ts is not None else None)
            return {
                "epoch": self._mem_epoch,
                "durable_epoch": self._durable_epoch,
                "last_commit_age_s": age,
                "commits": self.commits,
                "chunks_written": self.chunks_written,
                "write_failures": self.write_failures,
                "last_restore_source": self.last_restore_source,
                "disk_reads": self.disk_reads,
                "peer_shards_fetched": self.peer_shards_fetched,
            }

    # -------------------------------------------------------------- restore
    def restore(self, peers: Sequence[Tuple[str, int]] = (),
                decode: bool = True):
        """The restore decision: peers first, disk as the fallback.

        ``peers``: ``(addr, port)`` shard-server endpoints of candidate
        survivors.  When at least one reachable survivor holds an epoch
        NEWER than this rank's in-memory epoch, the state is allgathered
        as 1/K shards from the K newest-epoch survivors (any survivor
        re-serves a dead peer's shard) and verified against their blob
        digest — zero disk reads.  Otherwise (no quorum: no peers
        reachable, or none newer) the manifest path restores the newest
        complete on-disk epoch, quarantining corrupt shards with rank
        attribution.  Returns ``(state, epoch, source)`` with source
        ``"peer"`` or ``"disk"``."""
        result = None
        if peers:
            result = self._restore_from_peers(peers)
            if result is None and self._peer_attempted:
                self.restore_fallbacks += 1
        if result is None:
            blob, epoch, digest = self._restore_from_disk()
            source = "disk"
        else:
            blob, epoch, digest = result
            source = "peer"
        with self._lock:
            cur_epoch, cur_blob = self._mem_epoch, self._mem_blob
        if cur_blob is not None and epoch <= cur_epoch:
            # Never roll a rank BACKWARDS: a peer restore that degraded
            # to disk (the declared-newer survivor died mid-fetch) can
            # recover an epoch older than what this rank already holds
            # in memory — keep our own state (source "memory"), or a
            # re-ranked rank 0 would sync() the rollback to the fleet.
            log.warning(
                "state plane: recovered epoch %d from %s is not newer "
                "than this rank's in-memory epoch %d; keeping own state",
                epoch, source, cur_epoch)
            with self._lock:
                self.last_restore_source = "memory"
            return ((decode_state(cur_blob) if decode else cur_blob),
                    cur_epoch, "memory")
        with self._lock:
            self._mem_epoch = epoch
            self._mem_blob = blob
            self._mem_digest = digest
            self._remember(int(epoch), blob, digest)
            self.last_restore_source = source
        return (decode_state(blob) if decode else blob), epoch, source

    _peer_attempted = False

    def _restore_from_peers(self, peers
                            ) -> Optional[Tuple[bytes, int, str]]:
        from concurrent.futures import ThreadPoolExecutor
        self._peer_attempted = False
        my_epoch = self.epoch

        # Probe every candidate CONCURRENTLY: rendezvous records of
        # departed hosts each cost a full connect timeout, and a serial
        # sweep would delay the restore by seconds per corpse.
        def _probe(peer):
            addr, port = peer
            try:
                e, total, digest = peer_epoch(addr, port)
            except OSError:
                return None
            return (addr, port, e, total, digest)

        with ThreadPoolExecutor(max_workers=min(16, len(peers))) as pool:
            probed = list(pool.map(_probe, peers))
        alive = [a for a in probed
                 if a is not None and a[2] > my_epoch and a[3] > 0]
        if not alive:
            return None             # no quorum of newer-epoch survivors
        self._peer_attempted = True
        best = max(a[2] for a in alive)
        donors = [a for a in alive if a[2] == best]
        total, digest = donors[0][3], donors[0][4]
        k = len(donors)
        # A peer digests its piece before it answers: give the wait time
        # for a slow rate over the piece.
        timeout = FETCH_TIMEOUT_S + shard_bounds(total, k)[0] / FETCH_MIN_RATE

        # Fetch the K shards concurrently (the allgather shape that makes
        # 1/K sharding a wall-clock win, not just a load spread), round-
        # robin primary with every other donor as the fallback: a
        # survivor dying mid-restore costs one re-fetch, not the restore.
        def _fetch(i):
            order = [donors[(i + j) % k] for j in range(k)]
            for addr, port, _e, _t, _d in order:
                try:
                    return fetch_shard(addr, port, best, i, k,
                                       timeout=timeout,
                                       expect=digest if k == 1 else None)
                except OSError as exc:
                    log.warning(
                        "state plane: peer %s:%d failed serving shard "
                        "%d/%d of epoch %d (%s); trying the next survivor",
                        addr, port, i, k, best, exc)
            return None

        with ThreadPoolExecutor(max_workers=min(8, k)) as pool:
            shards = list(pool.map(_fetch, range(k)))
        self.peer_shards_fetched += sum(1 for s in shards if s is not None)
        if any(s is None for s in shards):
            log.warning("state plane: no survivor could serve every "
                        "shard of epoch %d; falling back to disk", best)
            return None
        if k == 1:
            # One piece, the whole blob, which fetch_shard verified
            # against the epoch's digest.
            return shards[0], best, digest
        blob = b"".join(shards)[:total]
        if blob_digest(blob) == digest:
            return blob, best, digest
        log.error("state plane: reassembled peer epoch %d failed its "
                  "digest check; falling back to disk", best)
        return None

    def _restore_from_disk(self) -> Tuple[bytes, int, str]:
        """Manifest path: newest complete epoch wins; a corrupt shard
        quarantines the file (``.quarantined``, attributed to the rank
        that wrote it) and sends the search to the next older epoch."""
        for epoch in reversed(list_epochs(self.directory)):
            manifests = epoch_manifests(self.directory, epoch)
            if manifests is None:
                continue
            world = manifests[0]["world"]
            d = _epoch_dir(self.directory, epoch)
            parts: List[bytes] = []
            ok = True
            for rec in manifests:
                path = os.path.join(
                    d, _shard_base(rec["rank"], world) + ".bin")
                try:
                    with open(path, "rb") as fh:
                        data = fh.read()
                    self.disk_reads += 1
                except OSError:
                    ok = False
                    break
                if (len(data) != rec["nbytes"]
                        or blob_digest(data) != rec["digest"]):
                    self._quarantine(path, rec, epoch)
                    ok = False
                    break
                parts.append(data)
            if not ok:
                continue
            blob = b"".join(parts)[:manifests[0]["total"]]
            if blob_digest(blob) != manifests[0]["blob_digest"]:
                log.error("state plane: epoch %d reassembly failed its "
                          "blob digest; skipping", epoch)
                continue
            return blob, epoch, manifests[0]["blob_digest"]
        raise FileNotFoundError(
            f"state plane: no restorable epoch under {self.directory!r} "
            f"(no peers with newer state, no complete manifest on disk)")

    def _quarantine(self, path: str, rec: dict, epoch: int) -> None:
        target = path + ".quarantined"
        try:
            os.replace(path, target)
        except OSError:
            target = path + " (unmovable)"
        self.quarantined.append(target)
        log.error(
            "state plane: CORRUPT shard quarantined — epoch %d shard "
            "written by rank %d fails its manifest digest (%s); moved to "
            "%s; trying the next older epoch", epoch, rec.get("rank"),
            rec.get("digest"), target)

    # ------------------------------------------------------------ lifecycle
    def set_declare(self, declare: Optional[Callable[[dict], None]]):
        self._declare = declare

    def flush(self, timeout: float = 30.0) -> bool:
        """Drain the in-flight durable write (clean shutdown)."""
        with self._lock:
            job = self._job
        if job is None:
            return True
        return self.wait_durable(job.epoch, timeout)

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None


# ----------------------------------------------- generation-surviving planes
_registry: Dict[str, StatePlane] = {}
_registry_lock = threading.Lock()


def obtain(directory: str, rank: int, world: int, engine=None,
           chunk_bytes: int = 1 << 20) -> StatePlane:
    """The engine's constructor hook: ONE plane per checkpoint directory
    per process, surviving elastic re-init exactly like the per-host
    agent — the in-memory committed epoch (what survivors serve to
    re-joiners) must outlive the generation that committed it.  Re-init
    re-binds rank/world/engine to the new assignment; the shard server
    and the epoch persist."""
    with _registry_lock:
        plane = _registry.get(directory)
        if plane is None:
            plane = StatePlane(directory, rank=rank, world=world,
                               engine=engine, chunk_bytes=chunk_bytes)
            _registry[directory] = plane
        else:
            plane.rank, plane.world = max(0, int(rank)), max(1, int(world))
            plane.engine = engine
            plane.chunk_bytes = max(1, int(chunk_bytes))
            if plane.server is None:
                plane.server = ShardServer(plane)
        return plane


# ------------------------------------------------- elastic-state integration
def attach(state, plane: Optional[StatePlane] = None):
    """Attach the live engine's state plane to an elastic ``State`` (the
    ``@hvd.elastic.run`` wrapper calls this whenever HOROVOD_CKPT_DIR is
    configured): ``state.commit()`` then also streams the durable shard,
    and the rank's epoch is declared in the rendezvous metadata after
    every commit.  No-op (returns None) when no plane is armed."""
    if plane is None:
        from ..common import basics
        eng = getattr(basics._get_state(), "engine", None)
        plane = getattr(eng, "stateplane", None) if eng is not None else None
    if plane is None:
        return None
    state._stateplane = plane
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
    if addr and port:
        from . import rendezvous as rdv
        from . import worker as ew
        ident = ew.identity()
        if ew._current_version is not None:
            plane.generation = int(ew._current_version)
        plane.set_declare(
            lambda rec, a=addr, p=int(port), i=ident:
            rdv.declare_state(a, p, i, rec))
        plane.declare_async()
    return plane


def maybe_restore(state, plane: StatePlane) -> Optional[str]:
    """Peer-first restore for a (re-)joining rank: read the rendezvous
    state directory, and when any survivor declares a newer epoch, pull
    the committed state from the survivors' shard servers (disk manifest
    as the fallback) and load it into ``state``.  Returns the restore
    source ('peer'/'disk') or None when this rank is already current."""
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
    if not addr or not port:
        return None
    from . import rendezvous as rdv
    from . import worker as ew
    ident = ew.identity()
    try:
        records = rdv.state_directory(addr, int(port))
    except OSError:
        return None
    best = plane.epoch
    peers = []
    for who, rec in records.items():
        if who == ident or not rec.get("port"):
            continue
        if int(rec.get("epoch", -1)) > plane.epoch:
            peers.append((who.rsplit(":", 1)[0], int(rec["port"])))
            best = max(best, int(rec["epoch"]))
    if not peers:
        return None
    try:
        data, epoch, source = plane.restore(peers=peers)
    except FileNotFoundError:
        return None
    if source == "memory":
        # Recovery found nothing newer than what this rank already
        # holds: leave the State object untouched.
        return None
    loader = getattr(state, "load_recovered", None)
    if loader is not None:
        # The State subclass owns the load: TorchState copies into the
        # live tensors on the card and re-slices a sharded optimizer's
        # own 1/N shard, riding the peer shard fetch directly instead of
        # waiting for the object-level sync() to cover it.
        loader(data)
    else:
        for k, v in data.items():
            setattr(state, k, v)
        state.save()
    log.warning("state plane: rank restored epoch %d from %s "
                "(declared best %d)", epoch, source, best)
    return source
