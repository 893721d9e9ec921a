"""The GPT-2 family and its continuous-batching server, in PyTorch.

Exports resolve lazily, so importing the package loads no model module.
"""

_EXPORTS = {
    "TransformerConfig": "transformer",
    "gpt2_small": "transformer",
    "tiny_config": "transformer",
    "init_params": "transformer",
    "params_from_jax": "transformer",
    "cast_params": "transformer",
    "forward": "transformer",
    "init_kv_cache": "transformer",
    "prefill": "transformer",
    "decode_step": "transformer",
    "generate": "transformer",
    "serve_greedy": "serving",
}
_SUBMODULES = ("decoding", "serving", "transformer")


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"mpi_acx_torch.models.{name}")
    if name in _EXPORTS:
        mod = importlib.import_module(f"mpi_acx_torch.models.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'mpi_acx_torch.models' has no attribute '{name}'")
