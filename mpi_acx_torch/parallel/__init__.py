"""The parallel layer of the train step, in PyTorch: the mesh over the
ranks of a ``torch.distributed`` world and its process groups, the axis
collectives (autograd Functions with the JAX step's transposes), the
multi-process runtime (``multihost``), the int8 quantized dp sync
(``quantized``), ring attention and the pipeline schedules (GPipe, its
interleaved form, and 1F1B); and ``kv_ship``, the host-plane KV handoff of
disaggregated serving (host numpy staging over the native runtime).

A mesh whose axes are all 1 needs no world: every collective is then the
identity.
"""
