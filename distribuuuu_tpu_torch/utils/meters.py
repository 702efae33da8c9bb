"""Progress meters and ETA (counterpart of distribuuuu_tpu/utils/meters.py)."""

from __future__ import annotations

import datetime


class AverageMeter:
    """The current value, running average, sum and count."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """One line of meters, with an ETA from the average batch time."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        num_digits = len(str(num_batches))
        fmt = "{:" + str(num_digits) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        return "  ".join(entries)

    def get_eta(self, batch: int, total_remaining_iters: int | None = None) -> str:
        """Remaining wall-clock time from the ``Time`` meter's average."""
        batch_time = next((m for m in self.meters if m.name == "Time"), None)
        if batch_time is None or batch_time.avg == 0:
            return "N/A"
        remaining = (self.num_batches - batch if total_remaining_iters is None
                     else total_remaining_iters)
        return str(datetime.timedelta(seconds=int(batch_time.avg * remaining)))


def construct_meters(num_batches: int, prefix: str, topk: int = 5):
    """Batch and data time, loss, top-1 and top-k meters and their line."""
    batch_time = AverageMeter("Time", ":6.3f")
    data_time = AverageMeter("Data", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    top1 = AverageMeter("Acc@1", ":6.2f")
    topk_m = AverageMeter(f"Acc@{topk}", ":6.2f")
    progress = ProgressMeter(num_batches, [batch_time, data_time, losses, top1, topk_m],
                             prefix=prefix)
    return batch_time, data_time, losses, top1, topk_m, progress
