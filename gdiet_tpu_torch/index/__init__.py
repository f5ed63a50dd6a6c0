"""Diet minimizer index of the port: holder, device tables, build."""

from gdiet_tpu_torch.index.build import TorchIndex, build_index

__all__ = ["TorchIndex", "build_index"]
