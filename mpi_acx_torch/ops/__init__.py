"""The port's kernels and their plain versions.

``attention`` holds the prefill flash-attention kernel (K1), ``flash_decode``
the decode-attention kernel (K2), ``flags`` the partition-signalling kernels
(B1-B5); ``_build`` compiles and loads them all.
"""
