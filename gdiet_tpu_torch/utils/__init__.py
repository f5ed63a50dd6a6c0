"""Shared utilities: profiling, logging."""

from gdiet_tpu_torch.utils.profile import PROFILE, Stage

__all__ = ["PROFILE", "Stage"]
