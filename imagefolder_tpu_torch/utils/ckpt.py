"""Checkpoints on ``torch.save`` (counterpart of
``imagefolder_tpu/utils/ckpt.py``, which is orbax's; reference monolithic
``torch.save`` dicts, ``xqgan_train.py:571-606``).

The reference's semantics: numbered checkpoints of which the last
``max_to_keep`` stay, a ``best`` checkpoint by a validation metric, resume
from the latest step, the loader's state beside them for an exact batch
order, and a small JSON of host-side state. Every file is written to a
temporary name and renamed, so a reader never sees half a file. In a
multi-process run only process 0 writes, behind barriers, and every process
reads (a shared filesystem, as upstream); each process keeps its own
loader state.

Layout under ``directory``: ``ckpts/step_<step>.pt``, ``best.pt``,
``data_state_rank<i>.bin`` and ``aux_state.json``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

from imagefolder_tpu_torch.parallel.dist import is_primary, process_index, sync_global_devices

__all__ = ["CheckpointManager"]

_STEP = re.compile(r"^step_(\d+)\.pt$")


def _atomic_save(obj: Any, path: Path):
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """States are dicts of tensors and host values (a trainer's
    ``state_dict()``); restore returns them on the CPU."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.ckpt_dir = self.directory / "ckpts"
        self.max_to_keep = max_to_keep
        self._primary = is_primary()
        if self._primary:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self._barrier("mkdir")  # the others wait for the tree to exist
        self.best_metric: Optional[float] = None

    def _barrier(self, tag: str):
        sync_global_devices(f"ckpt_{tag}")

    def steps(self) -> list:
        """The steps saved, in increasing order."""
        if not self.ckpt_dir.exists():
            return []
        return sorted(int(m.group(1)) for f in self.ckpt_dir.iterdir()
                      if (m := _STEP.match(f.name)))

    def save(self, step: int, state: Any):
        """Write ``state`` as ``step``'s checkpoint and keep the newest
        ``max_to_keep``."""
        if self._primary:
            _atomic_save(state, self.ckpt_dir / f"step_{step:08d}.pt")
            for old in self.steps()[:-self.max_to_keep]:
                (self.ckpt_dir / f"step_{old:08d}.pt").unlink(missing_ok=True)
        self._barrier("save")

    def save_best(self, state: Any, metric: float, lower_is_better: bool = True) -> bool:
        """Write ``best.pt`` if ``metric`` beats the best so far in this run
        (xqgan_train.py's save_best); returns whether it did."""
        better = self.best_metric is None or (
            metric < self.best_metric if lower_is_better else metric > self.best_metric)
        if better:
            self.best_metric = metric
            if self._primary:
                _atomic_save(state, self.directory / "best.pt")
        self._barrier("best")
        return better

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """(state on the CPU, step) of ``step`` or the latest one; (None, 0)
        when there is none (reference utils/misc.py:344-357)."""
        self._barrier("pre_restore")
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, 0
        state = torch.load(self.ckpt_dir / f"step_{step:08d}.pt", map_location="cpu",
                           weights_only=False)
        return state, step

    def _data_path(self) -> Path:
        return self.directory / f"data_state_rank{process_index()}.bin"

    def save_data_state(self, step: int, state: Optional[bytes]):
        """Keep the loader's state (``PrefetchIterator.state``) beside
        ``step``, so that a resumed run continues the exact batch stream
        (reference DistInfiniteBatchSampler.start_ep/start_it,
        utils/data_sampler.py:67-103). Each process keeps its own."""
        if state is None:
            return
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._data_path()
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_bytes(step.to_bytes(8, "little") + bytes(state))
        os.replace(tmp, path)

    def restore_data_state(self, step: int) -> Optional[bytes]:
        """The loader state saved at ``step``, or None when there is none or
        it is another step's (a fresh stream, as upstream)."""
        path = self._data_path()
        if not path.exists():
            return None
        blob = path.read_bytes()
        if int.from_bytes(blob[:8], "little") != step:
            return None
        return blob[8:]

    def apply_data_state(self, step: int, iterator, log=print) -> bool:
        """``restore_data_state`` into ``iterator.set_state``; a state the
        loader refuses (another folder, batch or seed) starts a fresh
        stream instead of stopping the run."""
        blob = self.restore_data_state(step)
        if blob is None:
            return False
        try:
            iterator.set_state(blob)
            return True
        except ValueError as e:
            log(f"data-stream state incompatible with this loader ({e}); "
                "falling back to a fresh stream")
            return False

    def save_aux(self, step: int, aux: dict):
        """Small host-side trainer state beside the checkpoints, as JSON
        (the reference's trainer dict inside ar-ckpt*.pth, train.py:249-261)."""
        if not self._primary:
            return
        path = self.directory / "aux_state.json"
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({"step": step, **aux}))
        os.replace(tmp, path)

    def restore_aux(self, step: int) -> Optional[dict]:
        """The aux state saved at ``step``, or None when absent or another
        step's."""
        path = self.directory / "aux_state.json"
        if not path.exists():
            return None
        try:
            d = json.loads(path.read_text())
        except ValueError:
            return None
        if d.pop("step", None) != step:
            return None
        return d

    def wait(self):
        """Writes are synchronous: a barrier, so that every process sees
        them."""
        self._barrier("wait")
