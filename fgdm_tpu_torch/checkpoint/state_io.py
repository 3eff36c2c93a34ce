"""Training-state checkpoints: a ``torch.save`` file a step, with orbax's
retention rules.

Counterpart of ``fgdm_tpu/checkpoint/orbax_io.py``'s ``CheckpointManager``
(the reference's Lightning ``.ckpt`` flow, ``main.py:594-676``), for the
tree of ``train/state.py state_to_pytree``.  The decisions are orbax's
(``CheckpointManagerOptions(max_to_keep=keep,
save_interval_steps=save_interval_steps)``):

* ``save(step, tree)`` writes when no checkpoint exists yet, or when
  ``step`` is past the latest saved and a multiple of
  ``save_interval_steps``;
  ``force=True`` writes whatever the interval.  A step that already has a
  file is never written again: the save returns False, as JAX's wrapper
  does for orbax's ``StepAlreadyExistsError`` (``orbax_io.py:30-41``).
* After a save only the ``keep`` files saved last stay (by the files'
  modification times: after a forced save of an earlier step that step
  stays and a later one goes, as in orbax).
* A file is written under a temporary name and renamed into place, so a
  crash mid-write leaves no partial checkpoint.
* ``restore`` reads to the host (``map_location="cpu"``); the caller copies
  into its live tensors (``state_from_pytree``), so a restore never makes a
  second copy of the state on the device.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_interval_steps = save_interval_steps

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def _by_age(self) -> List[int]:
        """The steps in the order they were saved (the files' modification
        times; a tie goes to the larger step)."""
        return sorted(self.all_steps(),
                      key=lambda s: (os.stat(self.path(s)).st_mtime_ns, s))

    def latest_step(self) -> Optional[int]:
        """The step saved last (as orbax: after a forced save of an earlier
        step, that step)."""
        steps = self._by_age()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is None:
            return True
        return latest < step and step % self.save_interval_steps == 0

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Write ``tree`` as ``step`` if the rules above allow; True if
        written."""
        if step in self.all_steps():
            return False
        if not force and not self.should_save(step):
            return False
        out = self.path(step)
        tmp = f"{out}.tmp-{os.getpid()}"
        try:
            torch.save(tree, tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        # orbax keeps the latest saves, not the largest steps
        for old in self._by_age()[:-self.keep]:
            os.remove(self.path(old))
        return True

    def restore(self, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (default the one saved last), on the
        host."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
