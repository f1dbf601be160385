"""``ray_tpu_torch.tune`` — hyperparameter search & trial execution.

Reference: ``python/ray/tune/``.  ``tune.report`` shares
the Train session transport (Train's ``fit`` and Tune trials are the same
report plumbing — mirroring the reference where Train runs on Tune).
"""

from __future__ import annotations

from ray_tpu_torch.train import get_checkpoint, report  # noqa: F401
from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler, AsyncHyperBandScheduler, FIFOScheduler,
    MedianStoppingRule, PB2, PopulationBasedTraining, TrialScheduler,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator, choice, grid_search, loguniform, qrandint,
    quniform, randint, randn, sample_from, uniform,
)
from ray_tpu_torch.tune.trainable import Trainable  # noqa: F401
from ray_tpu_torch.tune.trial import Trial  # noqa: F401
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid, TuneConfig, Tuner, run,
)
