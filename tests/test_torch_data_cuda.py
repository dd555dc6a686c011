"""The prefetcher on the card: ``prefetch_to_device`` copies each pinned
host batch on its side CUDA stream, makes the consumer's stream wait on
the copy's event and marks every yielded tensor used there
(``record_stream``), and the batches arrive bitwise.  Marked ``cuda``;
every test skips on a machine without a card.  Run on the card with
``python -m pytest tests/test_torch_data_cuda.py -m cuda`` (this file
imports no JAX).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import data


@pytest.fixture()
def cuda_device():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetcher's copy has no CPU "
                    "mode")
    return torch.device("cuda:0")


def _batches(n, rows=256, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, 1024).astype(np.float32),
             rng.randint(0, 1000, rows).astype(np.int64)) for _ in range(n)]


@pytest.mark.cuda
def test_cuda_prefetch_copies_on_a_side_stream_bitwise(cuda_device,
                                                       monkeypatch):
    """Every batch arrives bitwise, each tensor on the card; the copies
    ran on a stream other than the consumer's, whose stream waited on one
    event a batch, and each yielded tensor was recorded on the consumer's
    stream."""
    host = _batches(6)
    waits, recorded, copy_streams = [], [], []
    wait_event = torch.cuda.Stream.wait_event
    record_stream = torch.Tensor.record_stream
    to = torch.Tensor.to

    def spy_wait(self, event):
        waits.append(self.cuda_stream)
        return wait_event(self, event)

    def spy_record(self, stream):
        recorded.append((self.data_ptr(), stream.cuda_stream))
        return record_stream(self, stream)

    def spy_to(self, *args, **kwargs):
        if kwargs.get("non_blocking"):
            copy_streams.append(torch.cuda.current_stream().cuda_stream)
            assert self.is_pinned()
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.Stream, "wait_event", spy_wait)
    monkeypatch.setattr(torch.Tensor, "record_stream", spy_record)
    monkeypatch.setattr(torch.Tensor, "to", spy_to)
    consumer = torch.cuda.current_stream(cuda_device).cuda_stream
    got = []
    for x, y in data.prefetch_to_device(iter(host), size=2,
                                        device=cuda_device):
        assert x.device == y.device == cuda_device
        # Work queued on the consumer's stream reads the batch at once.
        got.append(((x * 1).cpu().numpy(), y.cpu().numpy()))
    monkeypatch.undo()
    assert len(got) == len(host)
    for (gx, gy), (hx, hy) in zip(got, host):
        np.testing.assert_array_equal(gx, hx)
        np.testing.assert_array_equal(gy, hy)
    assert len(copy_streams) == 2 * len(host)
    assert consumer not in set(copy_streams) and len(set(copy_streams)) == 1
    assert waits == [consumer] * len(host)
    assert len(recorded) == 2 * len(host)
    assert {s for _, s in recorded} == {consumer}


@pytest.mark.cuda
def test_cuda_prefetch_keeps_size_batches_in_flight(cuda_device):
    pulled = []

    def source():
        for i, b in enumerate(_batches(5, rows=8)):
            pulled.append(i)
            yield b

    ahead = [len(pulled) for _ in data.prefetch_to_device(
        source(), size=3, device=cuda_device)]
    assert ahead == [4, 5, 5, 5, 5]


@pytest.mark.cuda
def test_cuda_prefetch_of_sharded_batches_on_the_default_device(cuda_device):
    """The iterator's tensors through the prefetcher onto ``hvd.device()``
    (the card ``init()`` picked), bitwise the host rows."""
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init()
    try:
        x = np.random.RandomState(1).randn(64, 3, 8, 8).astype(np.float32)
        it = data.ShardedBatchIterator([x], batch_size=16, seed=2)
        host = [b[0].clone() for b in it]
        out = [b[0] for b in data.prefetch_to_device(it)]
        assert [t.device for t in out] == [hvd.device()] * len(host)
        for a, b in zip(out, host):
            assert torch.equal(a.cpu(), b)
    finally:
        hvd.shutdown()
