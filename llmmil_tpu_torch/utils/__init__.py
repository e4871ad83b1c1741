from .logging import MetricWriter
from .meters import AverageMeter, ProgressMeter
from .run_dir import dump_config, make_save_dir

__all__ = ["make_save_dir", "dump_config", "AverageMeter", "ProgressMeter",
           "MetricWriter"]
