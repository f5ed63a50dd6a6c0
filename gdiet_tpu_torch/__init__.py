"""gdiet_tpu_torch — the gdiet_tpu read mapper on PyTorch and CUDA.

A second package beside ``gdiet_tpu`` (JAX on a TPU), which stays the
reference: the port's integer outputs match it bit for bit and its SAM byte
for byte. The port imports ``torch`` and never JAX, and no module of
``gdiet_tpu`` either: it keeps its own copies of the framework-neutral host
modules (``config``, ``pattern``, ``debug``, ``io/``, ``oracle/``,
``index/cuckoo``, ``native/``, ``ops/sdust``, ``utils/profile``) at the same
relative paths.

Layout mirrors ``gdiet_tpu``: ``ops/`` (sketch, DP and its CUDA kernels),
``index/`` (index holder and build), ``pipeline/`` (the short-read fused
step and mapper, the long-read front and mapper), ``runtime.py`` and
``cli.py``. Every mapper and index takes an explicit ``device``; there is
no global device state.

Covered so far: short-read mapping (``-x sr``, single-end and paired-end)
and long-read mapping (``-x map-hifi|map-ont|map-pb|map-ccs``) to SAM, on
one device.
"""

__version__ = "0.1.0"
