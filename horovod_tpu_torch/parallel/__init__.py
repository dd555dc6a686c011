"""Parallel schemes beyond data parallelism: the process mesh and sequence
parallelism (ring and Ulysses attention).  Port of
``horovod_tpu/parallel/__init__.py:6-14``; ``spmd``, ``pipeline``,
``adasum``, ``hierarchical``, ``topology`` and ``zero`` are still to port
(``ROADMAP.md`` queue 1)."""

from .mesh import (  # noqa: F401
    DP, EP, PP, SP, TP, ProcessMesh, all_to_all, axes_of, infer_mesh,
    make_mesh, ppermute, require_axis, timed_ms,
)
from .ring_attention import (  # noqa: F401
    local_flash_attention, ring_attention,
)
from .ulysses import (  # noqa: F401
    heads_to_seq, seq_to_heads, ulysses_attention,
)
