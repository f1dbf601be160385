"""``ray_tpu_torch.data`` — distributed datasets on the port's runtime.

Reference: ``python/ray/data/`` (SURVEY.md §2.5): blocks in the object
store, lazy plans, streaming execution with backpressure, ``split`` for
per-worker shards, batch iteration and ``iter_device_batches`` (pinned
staging and a copy stream onto the card) for training ingest.  Importing
it imports neither torch, pyarrow nor pandas: the functions that need
them import them.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor  # noqa: F401
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import Dataset, GroupedData  # noqa: F401
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow, from_items, from_numpy, from_pandas, range, read_binary_files,
    read_csv, read_json, read_numpy, read_parquet, read_text,
)
