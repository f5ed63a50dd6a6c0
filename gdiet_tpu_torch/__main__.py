"""``python -m gdiet_tpu_torch`` — see gdiet_tpu_torch/cli.py."""

import sys

from gdiet_tpu_torch.cli import main

sys.exit(main())
