"""Device compute of the port: sketch, banded DP and backtrack (plain
torch + CUDA), and the host-side SDUST mask."""


class LaunchCount:
    """Plain integer count of one kernel's launches (or of one plain
    version's calls), so that a run can show which path it took."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0
