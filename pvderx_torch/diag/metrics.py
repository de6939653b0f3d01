"""Host-side structured metrics logging to JSONL (the counterpart of
`pvderx/diag/metrics.py`).

The batched functions return their metrics as dicts of tensors; this writer
flushes them, one JSON record per step with a wall-clock stamp, for
dashboards or TensorBoard.
"""
from __future__ import annotations

import json
import logging
import time


def get_logger(name: str = "pvderx_torch",
               level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        lg.addHandler(h)
        lg.setLevel(level)
    return lg


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps.

    ``tensorboard_dir`` mirrors every record to TensorBoard through
    `torch.utils.tensorboard` when its backend is installed, and is ignored
    with a warning when it is not. A metric may be a number or a one-element
    tensor (on any device: writing it syncs)."""

    def __init__(self, path: str | None = None, echo: bool = False,
                 tensorboard_dir: str | None = None):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self._log = get_logger()
        self._t0 = time.time()
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                self._log.warning("no TensorBoard writer available; "
                                  "tensorboard_dir ignored")

    def write(self, step: int, metrics: dict):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, int(step))
        if self.echo:
            self._log.info(" ".join(f"{k}={v:.5g}" for k, v in rec.items()))
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()
