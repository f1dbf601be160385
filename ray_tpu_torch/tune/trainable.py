"""Trainable: the unit Tune runs.

Reference: ``python/ray/tune/trainable/trainable.py`` — function API
(``def f(config): tune.report(...)``) and class API (``setup``/``step``/
``save_checkpoint``/``load_checkpoint``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint


class Trainable:
    """Class-API trainable.  The trial wrapper drives: setup(config), then
    step() per iteration (reporting its return dict), checkpointing via
    save_checkpoint/load_checkpoint around PBT clones and restores."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- user hooks
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- driver used by the trial wrapper
    def _train_loop(self, ckpt_freq: int = 0) -> None:
        """``ckpt_freq``: save every N iterations
        (``CheckpointConfig.checkpoint_frequency``); 0/1 → every iteration
        (kept as the default so schedulers can always clone/restore)."""
        import shutil
        import tempfile

        from ray_tpu_torch.train._internal.session import get_session
        sess = get_session()
        restore = sess.get_checkpoint()
        if restore is not None:
            with restore.as_directory() as d:
                self.load_checkpoint(d)
            self.iteration = max(self.iteration, sess.iteration)
        ckpt_freq = max(int(ckpt_freq), 1)
        try:
            while True:
                self.iteration += 1
                metrics = dict(self.step())
                if self.iteration % ckpt_freq != 0:
                    sess.report(metrics)
                    continue
                tmp = tempfile.mkdtemp(prefix="rtt_trainable_ckpt_")
                try:
                    self.save_checkpoint(tmp)
                    ckpt = (Checkpoint.from_directory(tmp)
                            if os.listdir(tmp) else None)
                    sess.report(metrics, checkpoint=ckpt)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        finally:
            self.cleanup()
