"""The port's kernels and their plain versions.

``attention`` holds the flash-attention kernel (K1: B6, the streaming
entry B7 and the row-logsumexp form B10) and its blockwise backward,
``flash_decode`` the decode-attention kernels (K2 over a fixed-slot cache,
B9 over a paged one, each for bf16/f32 and int8 caches), ``flags`` the
partition-signalling kernels (B1-B5); ``_build`` compiles and loads them all.
``mla`` (latent attention's prefill and decode) and ``moe_experts`` (the
router and the dropless routed experts) hold Triton kernels, built at
their first launch. ``kvquant`` (int8
KV-cache codes and scales), ``wquant`` and ``xent`` (chunked-vocab
cross-entropy) hold no kernel.
"""
