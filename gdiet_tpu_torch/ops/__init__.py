"""Device compute of the port: the sketch, the banded DP, the backtrack
and the votes, each kernel's wrapper beside its plain torch twin, and the
host-side SDUST mask. Nothing here imports the layers that call it
(``pipeline/``, ``parallel/``, ``runtime``, ``api``, ``cli``)."""


class LaunchCount:
    """Plain integer count of one kernel's launches (or of one plain
    version's calls), so that a run can show which path it took."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0
