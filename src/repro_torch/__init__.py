"""HPDedup on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch.core`` holds the dedup engines (host-side Python/numpy,
ported verbatim so their decisions match the reference bit for bit) over a
fingerprint index whose table lives on the card; ``repro_torch.kernels``
holds the hand-written CUDA kernels (``csrc/``) beside their plain PyTorch
versions.  The package imports neither JAX nor the ``repro`` package.
"""
