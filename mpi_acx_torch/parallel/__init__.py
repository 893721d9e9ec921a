"""The parallel layer of the train step, in PyTorch: the mesh, the axis
collectives, ring attention and the pipeline schedules (GPipe, its
interleaved form, and 1F1B); and ``kv_ship``, the host-plane KV handoff of
disaggregated serving (host numpy staging over the native runtime).

This slice runs them on one device: every mesh axis has size 1, where
each collective is exactly the identity. An axis larger than 1 raises
``NotImplementedError``: multi-rank training over ``torch.distributed``
is still to port (ROADMAP.md §A).
"""
