# Ported from horovod_tpu/spark/estimator.py:1-447: the materialization,
# the backends, _EstimatorBase and _ModelBase (:38-194) as they are, with
# the default store under the temporary directory; TorchEstimator/TorchModel
# (:294-374) over horovod_tpu_torch on hvd.device(); KerasEstimator/
# KerasModel (:377-447) over the port's Keras binding; no JaxEstimator.
"""Spark Estimator API: ``fit(DataFrame) -> Model`` (reference:
``horovod/spark/torch/estimator.py``, ``horovod/spark/keras/estimator.py``,
``horovod/spark/common/params.py`` — SURVEY.md §2b P11, VERDICT missing #3).

Flow, mirroring the reference:

1. **Materialize**: the DataFrame's feature/label columns are collected and
   written as ``num_proc`` numpy shards into the :class:`Store`
   (the reference materializes Parquet via Petastorm; numpy-npz shards
   keep the same Store layout without the Petastorm dependency).
2. **Train**: ``horovod_tpu_torch.spark.run`` executes the train function on
   every executor; each rank reads ITS shard from the store, trains with
   cross-rank gradient averaging through the coordinator, and rank 0
   writes the final parameters to the store's checkpoint path.
3. **Model**: ``fit`` returns a transformer holding the trained
   parameters; ``transform(df)`` appends a prediction column,
   ``predict(X)`` serves numpy directly.

Backends are pluggable: the default requires pyspark, and without it a
local in-process backend runs the train function once, at size 1 — the
same seam the reference's ``backend`` param provides.

Two frontends share the plumbing: :class:`TorchEstimator` (the reference's
headline API), which trains through ``horovod_tpu_torch`` on
``hvd.device()`` (its ``device`` argument picks another, as
``init(device=...)`` does), and :class:`KerasEstimator`, through the
port's Keras binding.
"""

from __future__ import annotations

import io
import os
import pickle
import tempfile
import uuid
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .store import LocalStore, Store


def _rows_to_arrays(df, feature_cols: Sequence[str],
                    label_cols: Sequence[str]):
    """DataFrame-ish → (X [N, F], y [N, L]) float32 arrays.

    Accepts a pyspark DataFrame (``select(...).collect()``), any object
    with the same shape of API (the test doubles), or a plain sequence of
    dict rows.
    """
    cols = list(feature_cols) + list(label_cols)
    if hasattr(df, "select"):
        rows = [tuple(r) for r in df.select(*cols).collect()]
    elif hasattr(df, "collect"):
        rows = [tuple(r[c] for c in cols) for r in df.collect()]
    else:
        rows = [tuple(r[c] for c in cols) for r in df]
    nf = len(feature_cols)
    if not rows:
        return (np.zeros((0, nf), np.float32),
                np.zeros((0, len(label_cols)), np.float32))
    data = np.asarray(rows, dtype=np.float32)
    return data[:, :nf], data[:, nf:]


def _write_shards(store: Store, X: np.ndarray, y: np.ndarray,
                  num_shards: int, run_id: str) -> int:
    """Round-robin partitioned materialization into the store's train-data
    paths (reference: the Petastorm parquet materialization step).

    Every shard is padded to the SAME length by wrapping around the global
    rows: ranks therefore run identical batch counts per epoch, which the
    lock-step collective schedule requires (unequal counts would leave one
    rank blocking in an allreduce its peers never join).  Paths are
    namespaced by ``run_id`` so concurrent fits sharing a store cannot
    overwrite each other's shards.
    """
    per = max(1, -(-len(X) // num_shards))      # ceil, >= 1 row per shard
    for i in range(num_shards):
        idxs = [(i + k * num_shards) % len(X) for k in range(per)]
        buf = io.BytesIO()
        np.savez(buf, X=X[idxs], y=y[idxs])
        store.write(store.get_train_data_path(i, run_id=run_id),
                    buf.getvalue())
    return num_shards


def _read_shard(store: Store, idx: int, run_id: str):
    data = np.load(io.BytesIO(
        store.read(store.get_train_data_path(idx, run_id=run_id))))
    return data["X"], data["y"]


def _local_backend(fn: Callable[[], Any], num_proc: int, env=None) -> List:
    """In-process backend for environments without pyspark (tests / direct
    use): runs the train function once in this process's world.  Refuses num_proc > 1 — training only shard 0 of a multi-shard
    materialization would silently drop most of the data."""
    if num_proc > 1:
        raise RuntimeError(
            "num_proc > 1 needs pyspark (the default Spark backend) or an "
            "explicitly injected backend that actually runs one process "
            "per rank; the in-process fallback would train on 1 shard of "
            f"{num_proc} and silently discard the rest")
    return [fn()]


def _spark_backend(fn: Callable[[], Any], num_proc: int, env=None) -> List:
    from . import run
    return run(fn, num_proc=num_proc, env=env)


class _EstimatorBase:
    """Shared param surface (reference: ``common/params.py``) + fit
    plumbing."""

    def __init__(self, *, feature_cols: Sequence[str],
                 label_cols: Sequence[str], store: Optional[Store] = None,
                 num_proc: Optional[int] = None, batch_size: int = 32,
                 epochs: int = 1, learning_rate: float = 0.01,
                 run_id: Optional[str] = None, backend=None, seed: int = 0,
                 verbose: int = 0):
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.store = store or LocalStore(os.path.join(
            tempfile.gettempdir(), "horovod_tpu_torch_estimator"))
        self.num_proc = num_proc
        self.batch_size = batch_size
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.run_id = run_id or f"run_{uuid.uuid4().hex[:8]}"
        self.backend = backend
        self.seed = seed
        self.verbose = verbose

    # Subclasses provide: _make_train_fn(num_proc) -> callable returning
    # final params on rank 0 (written to the store) and _make_model(params).

    def fit(self, df):
        num_proc = self.num_proc or 1
        X, y = _rows_to_arrays(df, self.feature_cols, self.label_cols)
        if len(X) == 0:
            raise ValueError("fit() got an empty DataFrame")
        _write_shards(self.store, X, y, num_proc, self.run_id)
        backend = self.backend
        if backend is None:
            backend = (_spark_backend if self._pyspark_available()
                       else _local_backend)
        ckpt_path = self.store.get_checkpoint_path(self.run_id)
        backend(self._make_train_fn(num_proc, ckpt_path), num_proc)
        params = pickle.loads(self.store.read(ckpt_path))
        return self._make_model(params)

    @staticmethod
    def _pyspark_available() -> bool:
        try:
            import pyspark  # noqa: F401
            return True
        except ImportError:
            return False


class _ModelBase:
    """Transformer returned by ``fit`` (reference: ``TorchModel`` /
    ``KerasModel``): holds trained params; ``transform`` appends an
    ``output_col`` prediction column, ``predict`` serves numpy."""

    def __init__(self, params, feature_cols: Sequence[str],
                 output_col: str = "prediction"):
        self.params = params
        self.feature_cols = list(feature_cols)
        self.output_col = output_col

    def predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, df):
        if hasattr(df, "withColumn"):   # pyspark DataFrame
            import pyspark.sql.functions as F
            from pyspark.sql.types import DoubleType
            model = self

            @F.udf(returnType=DoubleType())
            def _predict(*features):
                x = np.asarray(features, np.float32)[None]
                return float(model.predict(x).reshape(-1)[0])

            return df.withColumn(self.output_col,
                                 _predict(*self.feature_cols))
        rows = ([{c: r[c] for c in r} for r in df.collect()]
                if hasattr(df, "collect") else
                [dict(r) for r in df])
        X = np.asarray([[r[c] for c in self.feature_cols] for r in rows],
                       np.float32)
        preds = self.predict(X).reshape(len(rows), -1)
        for r, p in zip(rows, preds):
            r[self.output_col] = float(p[0]) if p.size == 1 else p.tolist()
        return rows


# ----------------------------------------------------------------- Torch
def _device(device):
    """``device``, else ``hvd.device()`` once the runtime is up, else the
    card (a transform on an executor with no runtime), which raises as
    ``init()`` does where there is none: the CPU is the caller's choice,
    ``device="cpu"``."""
    import torch
    from ..common import basics
    if device is not None:
        return torch.device(device)
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "TorchModel: no CUDA device is available and the runtime is "
            "not initialized; pass device='cpu' to predict on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class TorchModel(_ModelBase):
    def __init__(self, state_dict, model_factory, feature_cols,
                 output_col="prediction", device=None):
        super().__init__(state_dict, feature_cols, output_col)
        self.model_factory = model_factory
        self.device = device

    def predict(self, X: np.ndarray) -> np.ndarray:
        import torch
        dev = _device(self.device)
        model = getattr(self, "_model", None)
        if model is None:
            # Built once and reused: the pyspark transform UDF calls
            # predict per ROW — rebuilding the module each time would
            # construct millions of modules on a real DataFrame.
            model = self.model_factory()
            model.load_state_dict(self.params)
            model.to(dev).eval()
            self._model = model
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
            return model(x).cpu().numpy()


class TorchEstimator(_EstimatorBase):
    """Reference-parity estimator (``horovod/spark/torch/estimator.py``):
    ``model_factory`` builds the torch module, ``loss`` maps
    ``(pred, target) -> scalar``; training runs under the port's
    ``DistributedOptimizer`` on ``hvd.device()`` (or ``device``, which
    ``init`` also gets), from rank 0's broadcast parameters, so gradients
    average across executors.  The trained ``state_dict`` is stored on
    the CPU."""

    def __init__(self, *, model_factory, loss, device=None, **kwargs):
        super().__init__(**kwargs)
        self.model_factory = model_factory
        self.loss = loss
        self.device = device

    def _make_train_fn(self, num_proc: int, ckpt_path: str):
        store, run_id = self.store, self.run_id
        model_factory, loss_fn = self.model_factory, self.loss
        batch_size, epochs, lr = self.batch_size, self.epochs, self.learning_rate
        seed, verbose, device = self.seed, self.verbose, self.device

        def train():
            import torch
            import horovod_tpu_torch as hvd

            if not hvd.is_initialized():
                hvd.init(device=device)
            dev = _device(device)
            rank = hvd.rank()
            shard = rank if num_proc > 1 else 0
            X, y = _read_shard(store, shard, run_id)
            X, y = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
            torch.manual_seed(seed)
            model = model_factory().to(dev)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=lr),
                named_parameters=model.named_parameters())
            last = 0.0
            for epoch in range(epochs):
                for off in range(0, len(X), batch_size):
                    xb = X[off:off + batch_size]
                    yb = y[off:off + batch_size]
                    opt.zero_grad()
                    loss = loss_fn(model(xb), yb)
                    loss.backward()
                    opt.step()
                    last = float(loss.detach())
                if verbose:
                    print(f"[estimator] rank={rank} epoch={epoch} "
                          f"loss={last:.4f}")
            if rank == 0:
                state = {k: v.detach().cpu()
                         for k, v in model.state_dict().items()}
                store.write(ckpt_path, pickle.dumps(state))
            hvd.barrier()
            return last

        return train

    def _make_model(self, state_dict):
        return TorchModel(state_dict, self.model_factory, self.feature_cols,
                          device=self.device)


# ----------------------------------------------------------------- Keras
class KerasModel(_ModelBase):
    """Transformer for a fitted Keras model (reference:
    ``horovod/spark/keras/estimator.py KerasModel``): ``params`` is the
    ``get_weights()`` list; the module is rebuilt once per process."""

    def __init__(self, weights, model_factory, feature_cols,
                 output_col="prediction"):
        super().__init__(weights, feature_cols, output_col)
        self.model_factory = model_factory

    def predict(self, X: np.ndarray) -> np.ndarray:
        model = getattr(self, "_model", None)
        if model is None:
            model = self.model_factory()
            model(np.zeros_like(np.asarray(X, np.float32)[:1]))  # build
            model.set_weights(self.params)
            self._model = model
        return np.asarray(model(np.asarray(X, np.float32), training=False))


class KerasEstimator(_EstimatorBase):
    """Reference-parity Keras estimator (``horovod/spark/keras/``):
    ``model_factory`` builds the (uncompiled) ``keras.Model``; ``loss`` is
    a Keras loss (string or callable).  Each executor compiles with the
    binding's ``DistributedOptimizer``, broadcasts rank 0's initial
    weights, and fits its own shard — the Horovod Keras recipe run by the
    Spark backend.  ``optimizer_factory`` (optional) builds the inner
    Keras optimizer; default SGD(learning_rate).  ``device`` is the port's
    runtime's (``init(device=...)``): TF's own placement is TF's.

    Lightning variant: descoped (lightning is not installed);
    ``TorchEstimator`` covers the torch path.
    """

    def __init__(self, *, model_factory, loss, optimizer_factory=None,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.model_factory = model_factory
        self.loss = loss
        self.optimizer_factory = optimizer_factory
        self.device = device

    def _make_train_fn(self, num_proc: int, ckpt_path: str):
        store, run_id = self.store, self.run_id
        model_factory, loss = self.model_factory, self.loss
        opt_factory = self.optimizer_factory
        batch_size, epochs, lr = self.batch_size, self.epochs, self.learning_rate
        seed, verbose, device = self.seed, self.verbose, self.device

        def train():
            import keras
            import horovod_tpu_torch.keras as khvd
            from horovod_tpu_torch.tensorflow import barrier

            if not khvd.is_initialized():
                khvd.init(device=device)
            rank = khvd.rank()
            shard = rank if num_proc > 1 else 0
            X, y = _read_shard(store, shard, run_id)
            keras.utils.set_random_seed(seed)
            model = model_factory()
            opt = (opt_factory() if opt_factory is not None
                   else keras.optimizers.SGD(learning_rate=lr))
            model.compile(optimizer=khvd.DistributedOptimizer(opt), loss=loss)
            model(X[:1])  # build variables before broadcasting them
            khvd.broadcast_global_variables(model, root_rank=0)
            hist = model.fit(X, y, batch_size=batch_size, epochs=epochs,
                             verbose=verbose if rank == 0 else 0)
            if rank == 0:
                store.write(ckpt_path, pickle.dumps(model.get_weights()))
            barrier()
            return float(hist.history["loss"][-1])

        return train

    def _make_model(self, weights):
        return KerasModel(weights, self.model_factory, self.feature_cols)
