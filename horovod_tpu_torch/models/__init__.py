"""The port's model families.

Lazy submodule access, as ``horovod_tpu/models/__init__.py`` gives it:
``horovod_tpu_torch.models.resnet`` works after ``import
horovod_tpu_torch.models`` without importing every family eagerly.  The
transformer families (``llama``, ``bert``, ``vit``, ``gpt2``) and the
expert-parallel ones (``moe``, ``dlrm``) each name their split leaves in
``param_specs(cfg)``, which ``parallel.ShardedParallel`` and
``llama.shard_params`` read.  ``convert`` maps Hugging Face Llama,
Mistral and Mixtral state dicts onto Llama's parameters and back.
"""

_FAMILIES = ("llama", "gpt2", "bert", "vit", "resnet", "mnist", "moe", "dlrm",
             "convert")

__all__ = list(_FAMILIES)


def __getattr__(name):
    if name in _FAMILIES:
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod          # cache for next access
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_FAMILIES))
