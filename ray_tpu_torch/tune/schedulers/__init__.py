"""Trial schedulers (reference: ``python/ray/tune/schedulers/``)."""

from ray_tpu_torch.tune.schedulers.trial_scheduler import (  # noqa: F401
    FIFOScheduler, TrialScheduler,
)
from ray_tpu_torch.tune.schedulers.async_hyperband import (  # noqa: F401
    ASHAScheduler, AsyncHyperBandScheduler,
)
from ray_tpu_torch.tune.schedulers.median_stopping import (  # noqa: F401
    MedianStoppingRule,
)
from ray_tpu_torch.tune.schedulers.pbt import (  # noqa: F401
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.schedulers.pb2 import PB2  # noqa: F401
from ray_tpu_torch.tune.schedulers.hyperband import (  # noqa: F401
    HyperBandScheduler,
)
