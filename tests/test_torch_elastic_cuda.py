"""The elastic slice on the card (marked ``cuda``; every test skips on a
machine without a card).  Run on the card with ``python -m pytest
tests/test_torch_elastic_cuda.py -m cuda`` (this file imports no JAX).

- A ``TorchState`` of CUDA tensors keeps its saved copies on the host and
  restores into the same CUDA tensors, bitwise.
- A one-rank NCCL world is aborted (the elastic teardown) and formed
  again at another port, twice; its collective works each time and the
  card synchronizes after the last abort.
"""

import numpy as np
import pytest
import torch


@pytest.fixture()
def cuda_device():
    """The card; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the card's memory")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_torch_state_round_trip_of_cuda_tensors(cuda_device):
    from horovod_tpu_torch.elastic.state import TorchState
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g, device=cuda_device)
              .to(torch.bfloat16), "b": torch.randn(32, generator=g,
                                                     device=cuda_device)}
    ptrs = {k: t.data_ptr() for k, t in params.items()}
    want = {k: t.clone() for k, t in params.items()}
    st = TorchState(bcast_object=lambda o, root_rank=0: o, params=params,
                    step=1)
    saved = st._saved_state["params"]
    # Host copies: float32 as a numpy array, bfloat16 as a CPU tensor.
    assert isinstance(saved["b"], np.ndarray)
    assert saved["w"].device.type == "cpu"
    with torch.no_grad():
        for t in params.values():
            t.add_(1)
    st.restore()
    assert {k: t.data_ptr() for k, t in st.params.items()} == ptrs
    for k in params:
        assert torch.equal(params[k], want[k])


@pytest.mark.cuda
def test_torch_nccl_world_aborts_and_forms_again(cuda_device):
    import torch.distributed as dist
    from horovod_tpu_torch.common.net import reserve_ports
    from horovod_tpu_torch.elastic import worker
    torch.cuda.set_device(cuda_device)
    for _ in range(2):
        with reserve_ports(1) as held:
            (port,) = held.ports
            worker.init_distributed_resilient("nccl", "127.0.0.1", port, 1,
                                              0)
        t = torch.ones(1024, device=cuda_device)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        assert float(t[0]) == 1.0
        worker.teardown_distributed(abrupt=True)
        assert not dist.is_initialized()
    torch.cuda.synchronize()
