"""The GPT-2 family (forward, loss, stage slicing), the Llama family's
serving path (``models.llama``), the MoE family (``models.moe``, the
layer; ``models.moe_transformer``, the model), the DeepSeek-V2 family
(``models.deepseek_v2``: latent attention, dropless DeepSeekMoE), the
continuous-batching
servers (fixed-slot and paged KV caches, greedy and sampled),
disaggregated prefill/decode serving (``models.disagg``) and speculative
decoding (``models.speculative``), in PyTorch. The package-level
names ``init_params``, ``forward``, ``prefill``... are GPT-2's; the Llama,
MoE and DeepSeek-V2 ones live in their modules, which the servers take as
``family``.

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
    "loss_fn": "transformer",
    "stage_slice": "transformer",
    "stage_slice_interleaved": "transformer",
    "init_kv_cache": "transformer",
    "prefill": "transformer",
    "decode_step": "transformer",
    "generate": "transformer",
    "generate_sample": "transformer",
    "serve_greedy": "serving",
    "serve_sample": "serving",
    "serve_paged_greedy": "serving",
    "serve_disagg_greedy": "disagg",
    "PageAllocator": "kvpage",
    "RadixPrefixCache": "kvpage",
    "PagedKV": "kvpage",
    "init_page_pool": "kvpage",
    "LlamaConfig": "llama",
    "llama3_8b": "llama",
    "tiny_llama": "llama",
    "MoeConfig": "moe",
    "MoeTransformerConfig": "moe_transformer",
    "tiny_moe_config": "moe_transformer",
    "DeepseekV2Config": "deepseek_v2",
    "deepseek_v2_lite": "deepseek_v2",
    "tiny_deepseek_v2": "deepseek_v2",
    "speculative_generate": "speculative",
    "speculative_sample": "speculative",
}
_SUBMODULES = ("decoding", "deepseek_v2", "disagg", "kvpage", "llama", "moe",
               "moe_transformer", "serving", "speculative", "transformer")


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"mpi_acx_torch.models.{name}")
    if name in _EXPORTS:
        mod = importlib.import_module(f"mpi_acx_torch.models.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'mpi_acx_torch.models' has no attribute '{name}'")
