# Copied from horovod_tpu/spark/store.py:1-281.
"""Storage abstraction for Spark-style estimator workflows.

Parity: reference ``horovod/spark/common/store.py`` (SURVEY.md §2b P11):
a ``Store`` maps a run id to train-data / validation-data / checkpoint /
logs locations, with ``LocalStore`` for filesystems and a factory that
dispatches on the URL scheme.  Object-store backends (HDFS/S3/GCS/ABFS)
require their client libraries and raise a clear error when absent — on
TPU VMs the natural production store is GCS.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional


class Store:
    """Run-layout contract; ``_join`` is the single per-backend hook (local
    paths with mkdir vs. plain URL joins)."""

    def _join(self, *parts) -> str:
        raise NotImplementedError

    def get_train_data_path(self, idx=None, run_id=None) -> str:
        suffix = f".{idx}" if idx is not None else ""
        parts = ([run_id] if run_id else []) + [
            "intermediate_train_data" + suffix]
        return self._join(*parts)

    def get_val_data_path(self, idx=None, run_id=None) -> str:
        suffix = f".{idx}" if idx is not None else ""
        parts = ([run_id] if run_id else []) + [
            "intermediate_val_data" + suffix]
        return self._join(*parts)

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join(run_id, "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return self._join(run_id, "logs")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes):
        raise NotImplementedError

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Factory dispatching on scheme (reference: ``Store.create``)."""
        if prefix_path.startswith(("gs://", "gcs://")):
            return GCSStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith("hdfs://"):
            return HDFSStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith(("s3://", "s3a://")):
            return S3Store(prefix_path, *args, **kwargs)
        if prefix_path.startswith(("abfs://", "abfss://")):
            raise NotImplementedError(
                f"Store scheme of {prefix_path!r} is not supported; use "
                f"local, hdfs://, s3://, or gs:// paths")
        return LocalStore(prefix_path, *args, **kwargs)


class LocalStore(Store):
    """Filesystem store (reference: ``LocalStore``)."""

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path.rstrip("/")
        os.makedirs(self.prefix_path, exist_ok=True)

    def _join(self, *parts) -> str:
        path = os.path.join(self.prefix_path, *parts)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    def write(self, path: str, data: bytes):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # pid-unique tmp: concurrent writers (e.g. every estimator worker
        # materializing the same shards) must never share a staging file.
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def delete(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)


class RemoteStore(Store):
    """Shared object-store layout (reference: the HDFS/S3/GCS/ABFS stores
    in ``horovod/spark/common/store.py`` share one path scheme).

    The run/checkpoint/data/logs layout is identical to ``LocalStore`` but
    joined as URLs; I/O goes through a tiny filesystem adapter
    (``exists/read/write/delete`` on full URLs).  ``fs`` is injectable so
    the layout + plumbing are testable without the client library; when
    absent, :meth:`_make_fs` imports the real client and raises a clear
    ImportError if the environment lacks it (DESIGN.md "Descopes": none of
    the client libraries are in the TPU image — the remote I/O legs are
    environment-blocked, the contract is not).
    """

    def __init__(self, prefix_path: str, fs=None):
        self.prefix_path = prefix_path.rstrip("/")
        self._fs = fs if fs is not None else self._make_fs()

    def _make_fs(self):  # pragma: no cover - needs the client library
        raise NotImplementedError

    def _join(self, *parts) -> str:
        return "/".join([self.prefix_path] + [p.strip("/") for p in parts])

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def read(self, path: str) -> bytes:
        return self._fs.read(path)

    def write(self, path: str, data: bytes):
        self._fs.write(path, data)

    def delete(self, path: str):
        self._fs.delete(path)


class HDFSStore(RemoteStore):
    """HDFS-backed store; requires ``pyarrow`` with HDFS support."""

    def _make_fs(self):
        try:
            from pyarrow import fs as pafs
            hdfs = pafs.HadoopFileSystem.from_uri(self.prefix_path)
        except Exception as exc:
            # pyarrow absent, or present without libhdfs / a reachable
            # cluster — either way the dependency is missing here.
            raise ImportError(
                "HDFSStore requires pyarrow with libhdfs and a reachable "
                "HDFS cluster, which this environment lacks; pass fs= "
                "explicitly or use a LocalStore") from exc
        if isinstance(hdfs, tuple):  # pragma: no cover - from_uri variants
            hdfs = hdfs[0]
        return _ArrowFS(hdfs)  # pragma: no cover - needs a live cluster


class S3Store(RemoteStore):
    """S3-backed store; requires ``boto3``."""

    def _make_fs(self):  # pragma: no cover - needs boto3 + credentials
        try:
            import boto3  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "S3Store requires boto3, which is not installed in this "
                "environment; pass fs= explicitly or use a LocalStore"
            ) from exc
        return _Boto3FS(boto3.client("s3"))


class GCSStore(RemoteStore):
    """GCS-backed store (the natural production store on TPU VMs);
    requires ``google-cloud-storage``."""

    def _make_fs(self):  # pragma: no cover - needs GCS client + creds
        try:
            from google.cloud import storage
        except ImportError as exc:
            raise ImportError(
                "GCSStore requires google-cloud-storage, which is not "
                "installed in this environment; pass fs= explicitly or "
                "use a LocalStore") from exc
        return _GCSClientFS(storage.Client())


def _split_bucket(url: str):
    rest = url.split("://", 1)[1]
    bucket, _, key = rest.partition("/")
    return bucket, key


class _Boto3FS:  # pragma: no cover - needs boto3 + credentials
    def __init__(self, client):
        self._c = client

    def exists(self, path):
        b, k = _split_bucket(path)
        try:
            self._c.head_object(Bucket=b, Key=k)
            return True
        except Exception:
            resp = self._c.list_objects_v2(Bucket=b, Prefix=k.rstrip("/")
                                           + "/", MaxKeys=1)
            return resp.get("KeyCount", 0) > 0

    def read(self, path):
        b, k = _split_bucket(path)
        return self._c.get_object(Bucket=b, Key=k)["Body"].read()

    def write(self, path, data):
        b, k = _split_bucket(path)
        self._c.put_object(Bucket=b, Key=k, Body=data)

    def delete(self, path):
        b, k = _split_bucket(path)
        resp = self._c.list_objects_v2(Bucket=b, Prefix=k)
        for obj in resp.get("Contents", []):
            self._c.delete_object(Bucket=b, Key=obj["Key"])


class _GCSClientFS:  # pragma: no cover - needs GCS client + creds
    def __init__(self, client):
        self._c = client

    def _blob(self, path):
        b, k = _split_bucket(path)
        return self._c.bucket(b).blob(k)

    def exists(self, path):
        if self._blob(path).exists():
            return True
        b, k = _split_bucket(path)
        return any(True for _ in self._c.list_blobs(
            b, prefix=k.rstrip("/") + "/", max_results=1))

    def read(self, path):
        return self._blob(path).download_as_bytes()

    def write(self, path, data):
        self._blob(path).upload_from_string(data)

    def delete(self, path):
        b, k = _split_bucket(path)
        for blob in self._c.list_blobs(b, prefix=k):
            blob.delete()


class _ArrowFS:  # pragma: no cover - needs pyarrow HDFS + cluster
    def __init__(self, fs):
        self._fs = fs

    @staticmethod
    def _path(url):
        return "/" + url.split("://", 1)[1].split("/", 1)[1]

    def exists(self, path):
        from pyarrow import fs as pafs
        info = self._fs.get_file_info(self._path(path))
        return info.type != pafs.FileType.NotFound

    def read(self, path):
        with self._fs.open_input_stream(self._path(path)) as fh:
            return fh.read()

    def write(self, path, data):
        p = self._path(path)
        parent = p.rsplit("/", 1)[0]
        self._fs.create_dir(parent, recursive=True)
        with self._fs.open_output_stream(p) as fh:
            fh.write(data)

    def delete(self, path):
        from pyarrow import fs as pafs
        p = self._path(path)
        info = self._fs.get_file_info(p)
        if info.type == pafs.FileType.Directory:
            self._fs.delete_dir(p)
        elif info.type != pafs.FileType.NotFound:
            self._fs.delete_file(p)
