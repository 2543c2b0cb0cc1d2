"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``fingerprint`` — lane-parallel 128-bit block hashing (``csrc/fingerprint.cu``).
* ``fp_index``    — exact open-addressing fingerprint-index probe, insert and
  remove over one flat int64 table (``csrc/fp_index.cu``).
* ``ops``         — dtype viewing, padding, host<->device moves and the
  64-bit folds the engines consume.
* ``ref``         — independent oracles for the fingerprint.
* ``_build``      — ``nvcc`` build, ``ctypes`` loading and launch counts.

A wrapper takes the plain version for a CPU tensor and launches its kernel
for a CUDA tensor; kernels build at first launch, never at import.
"""
