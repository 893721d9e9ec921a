"""The parallel layer in PyTorch: the mesh over the ranks of a
``torch.distributed`` world and its process groups, the axis collectives
(autograd Functions with the JAX step's transposes), the multi-process
runtime (``multihost``), the int8 quantized dp sync (``quantized``), ring
attention and Ulysses sequence parallelism, the partitioned exchange, the
pipeline schedules (GPipe, its interleaved form, and 1F1B), tensor-parallel
inference (``tp_inference``: generation, speculative decoding and
continuous batching for the three families); and ``kv_ship``, the
host-plane KV handoff of disaggregated serving (host numpy staging over
the native runtime).

A mesh whose axes are all 1 needs no world: every collective is then the
identity. The JAX package's exports are here under its names, but for
``ring_attention``, which names the submodule (its function is
``ring_attention.ring_attention``: a submodule's import would replace a
package attribute of that name). They resolve lazily, so importing the
package loads no submodule.
"""

_EXPORTS = {
    "make_mesh": "mesh",
    "mesh_from_devices": "mesh",
    "ring_shift": "collective",
    "neighbor_exchange": "collective",
    "halo_exchange_1d": "collective",
    "halo_exchange_2d": "collective",
    "all_to_all_seq": "collective",
    "partitioned_ring_exchange": "partitioned",
    "partitioned_pipeline": "partitioned",
    "ring_attention_batched": "ring_attention",
    "ring_attention_sharded": "ring_attention",
    "blockwise_attention_reference": "ring_attention",
    "pipeline_1f1b_loss_and_grads": "pipeline",
    "pipeline_forward": "pipeline",
    "pipeline_forward_interleaved": "pipeline",
    "pipeline_loss": "pipeline",
    "ulysses_attention": "ulysses",
    "ulysses_attention_sharded": "ulysses",
    "quantized_pmean": "quantized",
    "quantized_psum": "quantized",
    "ring_psum": "quantized",
    "make_tp_generate": "tp_inference",
    "make_tp_generate_llama": "tp_inference",
    "make_tp_generate_moe": "tp_inference",
    "make_tp_speculative_generate": "tp_inference",
    "tp_param_specs": "tp_inference",
    "tp_param_specs_llama": "tp_inference",
    "tp_param_specs_moe": "tp_inference",
    "tp_shard_params": "tp_inference",
    "tp_shard_params_llama": "tp_inference",
    "tp_shard_params_moe": "tp_inference",
}
_SUBMODULES = ("collective", "kv_ship", "mesh", "multihost", "partitioned",
               "pipeline", "quantized", "ring_attention", "tp_inference",
               "ulysses")


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"mpi_acx_torch.parallel.{name}")
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"mpi_acx_torch.parallel.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'mpi_acx_torch.parallel' has no attribute '{name}'")
