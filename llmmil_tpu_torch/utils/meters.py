"""Console progress meters (the JAX package's ``utils/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    """Running average with formatted display."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
                ).format(**self.__dict__)


class ProgressMeter:
    """Batch-indexed meter line printer."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        digits = len(str(num_batches))
        self.batch_fmt = "[" + "{:" + str(digits) + "d}" \
            + "/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)
