"""Framework-neutral host modules of ``gdiet_tpu``, reached without JAX.

The port shares the JAX package's host code instead of copying it: options
(``config``), the diet pattern maths (``pattern``), the stage tracer
(``debug``), FASTA/FASTQ and SAM I/O (``io.fastx``, ``io.sam``), the scalar
oracle (``oracle.*``), the native C runtime (``native``), the cuckoo table
builder (``index.cuckoo``) and the stage profiler (``utils.profile``). None of
them imports JAX, but ``gdiet_tpu/__init__.py`` and
``gdiet_tpu/index/__init__.py`` do.

The rule:

- if ``gdiet_tpu`` is already imported, or JAX can be imported, the real
  package is used (the CPU tests run both frameworks in one process, and the
  JAX side must keep its x64 setting);
- otherwise (a machine without JAX, such as the GPU host) bare parent
  modules stand in for ``gdiet_tpu`` and ``gdiet_tpu.index``: their
  ``__path__`` points at the package directories and ``gdiet_tpu`` carries
  ``__version__``, so that only the modules above are executed.

``MODE`` records which of the two happened ("package" or "bare").
"""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import re
import sys
import types

_PKG = pathlib.Path(__file__).resolve().parent.parent / "gdiet_tpu"


def _register_bare_parents() -> None:
    version = re.search(
        r'^__version__ = "([^"]+)"', (_PKG / "__init__.py").read_text(), re.M
    ).group(1)
    for name, path in (("gdiet_tpu", _PKG), ("gdiet_tpu.index", _PKG / "index")):
        mod = types.ModuleType(name, f"bare parent of {name} (no JAX)")
        mod.__path__ = [str(path)]
        mod.__package__ = name
        sys.modules[name] = mod
    sys.modules["gdiet_tpu"].__version__ = version
    sys.modules["gdiet_tpu"].index = sys.modules["gdiet_tpu.index"]


if "gdiet_tpu" in sys.modules or importlib.util.find_spec("jax") is not None:
    importlib.import_module("gdiet_tpu")
    MODE = "package" if hasattr(sys.modules["gdiet_tpu"], "__file__") else "bare"
else:
    _register_bare_parents()
    MODE = "bare"

from gdiet_tpu import config, debug, native, pattern  # noqa: E402
from gdiet_tpu.index import cuckoo  # noqa: E402
from gdiet_tpu.io import fastx, sam  # noqa: E402
from gdiet_tpu.oracle import align, hit as oracle_hit, pipeline as oracle_pipeline, sketch as oracle_sketch  # noqa: E402
from gdiet_tpu.utils import profile  # noqa: E402

__version__ = sys.modules["gdiet_tpu"].__version__


def require_native():
    """The native C runtime, or an error: without it the SR and PE
    finishes would silently switch to the slow Python regs path."""
    if native.lib is None:
        raise RuntimeError(
            "gdiet_tpu native library unavailable (no C compiler?): the port "
            "needs native.sr_finish_batch / pe_finish_batch for the short-read "
            "finish"
        )
    return native


__all__ = [
    "MODE", "__version__", "align", "config", "cuckoo", "debug", "fastx",
    "native", "oracle_hit", "oracle_pipeline", "oracle_sketch", "pattern",
    "profile", "require_native", "sam",
]
