"""Scalar logging (counterpart of ``nerfjax/logging_utils.py``): the same
scalar names (Loss/Coarse, Loss/Fine, Loss/Total, PSNR, Scheduler Step,
rays_per_sec) through tensorboardX where it is installed, stdout only
otherwise."""

from __future__ import annotations

from pathlib import Path


class Logger:
    def __init__(self, logdir: str | Path):
        self._writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            print(f"[logging] TensorBoard writer unavailable ({e}); stdout only")
            return
        Path(logdir).mkdir(parents=True, exist_ok=True)
        self._writer = SummaryWriter(str(logdir))

    def scalars(self, step: int, values: dict[str, float]) -> None:
        if self._writer is not None:
            for name, v in values.items():
                self._writer.add_scalar(name, v, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
