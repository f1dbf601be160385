"""``python -m ray_tpu_torch`` → the CLI (reference: the ``ray`` console script)."""

import sys

from ray_tpu_torch.scripts.cli import main

sys.exit(main())
