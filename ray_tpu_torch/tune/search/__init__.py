"""Search spaces and searchers (reference: ``python/ray/tune/search/``)."""

from ray_tpu_torch.tune.search.sample import (  # noqa: F401
    Categorical, Domain, Float, Integer, choice, grid_search, loguniform,
    qrandint, quniform, randint, randn, sample_from, uniform,
)
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator  # noqa: F401
from ray_tpu_torch.tune.search.searcher import Searcher  # noqa: F401
from ray_tpu_torch.tune.search.tpe import TPESearcher  # noqa: F401
from ray_tpu_torch.tune.search.bohb import BOHBSearcher, HyperBandForBOHB  # noqa: F401
from ray_tpu_torch.tune.search.adapters import (  # noqa: F401
    HyperOptSearch, OptunaSearch,
)
