"""The port's examples, each run as a module under the port's launcher,
e.g. ``python -m horovod_tpu_torch.runner -np 2 python -m
horovod_tpu_torch.examples.moe_expert_parallel``."""
