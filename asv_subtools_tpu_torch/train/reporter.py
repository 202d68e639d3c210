"""Training reporter: CSV log + stdout progress (the port's own copy of
asv_subtools_tpu/train/reporter.py; parity:
pytorch/libs/training/reporter.py).

The reference runs a child process fed by a Queue to keep the train loop
unblocked (reporter.py:83-90); here the metrics are host-side floats the
Trainer fetched at its report points, so a background thread with a small
queue suffices (writes never block the card).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
import time
from typing import Dict, Optional


class Reporter:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        filename: str = "train.csv",
        print_interval: int = 1,
        use_tensorboard: bool = False,
    ):
        self.log_dir = log_dir
        self.print_interval = print_interval
        self._q: "queue.Queue" = queue.Queue(maxsize=1024)
        self._fields = None
        self._csv_path = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, filename)
            if os.path.exists(self._csv_path):  # backup-on-rerun (reporter.py:66)
                os.replace(self._csv_path, self._csv_path + f".bak.{int(time.time())}")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None
        self._n = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def update(self, **metrics: float) -> None:
        self._n += 1
        try:
            self._q.put_nowait(dict(metrics))
        except queue.Full:
            pass
        if self._n % self.print_interval == 0:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[train] {parts}", flush=True)

    def _worker(self):
        writer = None
        f = None
        while True:
            row = self._q.get()
            if row is None:
                break
            if self._csv_path:
                if writer is None:
                    f = open(self._csv_path, "w", newline="")
                    self._fields = list(row.keys())
                    writer = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
                    writer.writeheader()
                writer.writerow(row)
                f.flush()
            if self._tb is not None:
                step = int(row.get("iteration", 0))
                for k, v in row.items():
                    if isinstance(v, (int, float)):
                        self._tb.add_scalar(k, v, step)

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)


def read_report_csv(path: str) -> Dict[str, list]:
    """Read a train.csv back into columns (floats where possible)."""
    out: Dict[str, list] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    pass
                out.setdefault(k, []).append(v)
    return out


def grab_metric(
    log_path: str, metric: str = "train_loss", epoch: Optional[int] = None
) -> list:
    """Pull one metric's trajectory out of a training log (parity:
    grabLossValue.sh — greps loss values from reference run logs for
    plotting/epoch comparison). `epoch` filters to one epoch's rows."""
    cols = read_report_csv(log_path)
    if metric not in cols:
        raise KeyError(f"{metric!r} not in {sorted(cols)}")
    vals = cols[metric]
    if epoch is not None and "epoch" in cols:
        vals = [v for v, e in zip(vals, cols["epoch"]) if int(float(e)) == epoch]
    return vals
