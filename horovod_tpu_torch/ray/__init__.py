# Copied from horovod_tpu/ray/__init__.py:1-9.
"""Ray integration (reference: ``horovod/ray`` — SURVEY.md §2b P12).

``RayExecutor`` places workers as Ray actors; ``strategy`` holds the pure
pack/spread placement logic (usable and tested without Ray installed).
"""

from .runner import RayExecutor  # noqa: F401
from .strategy import Allocation, NodeResources, pack, spread  # noqa: F401
from .elastic import ElasticRayExecutor, RayHostDiscovery  # noqa: F401
