"""Lightweight metrics: a logging and CSV callback for the sampler's
per-step diagnostics.

PyTorch counterpart of ``stein_tpu/utils/metrics.py``: step time, pre-clip
||phi||, bandwidth h^2 and mean log-posterior, with optional CSV capture."""

import csv
import logging
import os
import time

from .hostio import host_scalar

logger = logging.getLogger("stein_tpu_torch")


class MetricsLogger:
    """Collects per-step diagnostics from SVGDSampler.train_on_batch aux.

    Usage:
        metrics = MetricsLogger(log_every=100, csv_path="run.csv")
        for step in ...:
            aux = sampler.train_on_batch(batch)
            metrics.record(step, aux)

    ``resume=True`` appends to an existing CSV instead of truncating it,
    for the crash-recovery loop (utils/recovery.py): a restart keeps the
    metric history from before the crash.

    Each ``record`` reads its four scalars on the host, which waits for
    the device work queued before it.
    """

    def __init__(self, log_every=100, csv_path=None, resume=False):
        self.log_every = log_every
        self.csv_path = csv_path
        self.resume = resume
        self._csv_file = None
        self._csv_writer = None
        self._last_time = None
        self._last_step = None
        self.history = []

    def record(self, step, aux):
        # interval_s is the wall time between record() calls;
        # avg_step_time_s divides it by the step delta (the caller's own
        # work between the calls included).
        now = time.perf_counter()
        step = int(step)
        interval = None if self._last_time is None else now - self._last_time
        avg_step = (
            interval / (step - self._last_step)
            if interval is not None and self._last_step is not None
            and step > self._last_step else None
        )
        self._last_time = now
        self._last_step = step
        row = {
            "step": step,
            "interval_s": interval,
            "avg_step_time_s": avg_step,
            "phi_norm": host_scalar(aux["phi_norm"]),
            "h2": host_scalar(aux["h2"]),
            "log_p_mean": (host_scalar(aux["log_p_mean"])
                           if "log_p_mean" in aux else float("nan")),
        }
        self.history.append(row)
        if self.csv_path is not None:
            if self._csv_writer is None:
                self._open_csv(list(row))
            self._csv_writer.writerow(row)
            self._csv_file.flush()
        if self.log_every and step % self.log_every == 0:
            logger.info(
                "step=%d phi_norm=%.4g h2=%.4g log_p_mean=%.6g interval=%s",
                row["step"], row["phi_norm"], row["h2"], row["log_p_mean"],
                f"{interval:.4f}s" if interval is not None else "n/a",
            )

    def _open_csv(self, fields):
        append = (self.resume and os.path.exists(self.csv_path)
                  and os.path.getsize(self.csv_path) > 0)
        if append:
            # DictWriter appends values by position: a file with other
            # columns would misalign every appended row, so refuse it.
            with open(self.csv_path, newline="") as f:
                header = f.readline().strip().split(",")
            if header != fields:
                raise ValueError(
                    f"cannot resume metrics CSV {self.csv_path}: existing "
                    f"header {header} != current fields {fields} (delete "
                    "the file or use a new path)"
                )
        self._csv_file = open(self.csv_path, "a" if append else "w",
                              newline="")
        self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=fields)
        if not append:
            self._csv_writer.writeheader()

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
            self._csv_writer = None
