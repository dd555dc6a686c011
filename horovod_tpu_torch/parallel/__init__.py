"""Parallel schemes beyond data parallelism: the process mesh with
Megatron's tensor-parallel pair, sequence parallelism (ring and Ulysses
attention), pipeline parallelism (GPipe over the mesh's pp groups), the
gradient rule of leaves split over mesh axes (tensor, expert and pipeline
parallelism), the eager SPMD harness, Adasum, the two-level collectives
and the slice topology they run on.  Port of
``horovod_tpu/parallel/__init__.py:6-14``; ``zero`` holds the ZeRO
pad+slice convention (its in-graph optimizers have no counterpart)."""

from .adasum import (  # noqa: F401
    adasum_allreduce, adasum_allreduce_hd, adasum_allreduce_hier,
    adasum_combine, vhd,
)
from .expert import (  # noqa: F401
    DATA_AXES, ExpertParallel, ShardedParallel, Split, Splits,
    refuse_world_averaged, shard_on_mesh, shard_tree, spec_of, split_named,
    split_of, splits_of,
)
from .hierarchical import (  # noqa: F401
    Legs, hierarchical_allgather, hierarchical_allreduce,
    hierarchical_allreduce_minmax, hierarchical_broadcast,
)

from .mesh import (  # noqa: F401
    DP, EP, PP, SP, TP, AllToAll, CopyInput, PPermute, ProcessMesh,
    ReduceOutput, all_gather, all_to_all, axes_of, infer_mesh, make_mesh,
    ppermute, psum, require_axis, send_recv, timed_ms,
)
from .pipeline import microbatch, pipeline_apply, stage_index  # noqa: F401
from .ring_attention import (  # noqa: F401
    local_flash_attention, ring_attention,
)
from .spmd import (  # noqa: F401
    infer_specs_like, local_batch, make_sharded_train_step, shard_params,
)
from .topology import (  # noqa: F401
    SliceTopology, cross_fraction, hier_bit_orders, modeled_leg_bytes,
    parse_slice_map, slice_topology,
)
from .ulysses import (  # noqa: F401
    heads_to_seq, seq_to_heads, ulysses_attention,
)
from .zero import shard_info, shard_slice_host, unshard_host  # noqa: F401
