"""gdiet_tpu_torch — the gdiet_tpu read mapper on PyTorch and CUDA.

A second package beside ``gdiet_tpu`` (JAX on a TPU), which stays the
reference: the port's integer outputs match it bit for bit and its SAM byte
for byte. The port imports ``torch`` and never JAX. Framework-neutral host
code (options, I/O, the scalar oracle, the native C runtime) is shared with
``gdiet_tpu`` through ``_host`` rather than copied.

Layout mirrors ``gdiet_tpu``: ``ops/`` (sketch, DP and its CUDA kernel),
``index/`` (index holder and build), ``pipeline/`` (fused step and the
short-read mapper), ``runtime.py`` and ``cli.py``. Every mapper and index
takes an explicit ``device``; there is no global device state.

Covered so far: short-read mapping (``-x sr``) to SAM, single device.
"""
