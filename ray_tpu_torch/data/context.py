"""DataContext: execution knobs.

Reference: ``python/ray/data/context.py`` — a process-wide singleton of
execution options (block sizes, parallelism, backpressure limits).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class DataContext:
    # blocks created by read_*/from_* when override_num_blocks is unset
    default_parallelism: int = 8
    # streaming executor: max concurrently running block tasks per stage
    # (this is the backpressure bound — reference: resource-based limits)
    max_tasks_in_flight: int = 8
    target_max_block_size: int = 128 * 1024 * 1024
    # rows per batch when batch_size is unset in map_batches
    default_batch_size: int = 1024
    use_push_based_shuffle: bool = True
    # "numpy" (default: dict-of-ndarray blocks, zero-copy out of the shm
    # store, staged onto the card by iter_device_batches) or "arrow" (pyarrow Table
    # blocks: zero-copy slice/concat, schema'd tabular path, conversion-
    # free parquet IO — the reference's block representation)
    block_format: str = "numpy"

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance
