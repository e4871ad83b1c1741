"""Host-side data layer of the port: cohort, clinical information, CT
preprocessing and augmentation, bags, tokenizer, dataset and loader."""

from .bags import DEFAULT_BUCKETS, bucket_for, instance_dropout, pad_bag
from .pipeline import BatchLoader, MultimodalDataset, SyntheticCohort

__all__ = ["DEFAULT_BUCKETS", "bucket_for", "instance_dropout", "pad_bag",
           "BatchLoader", "MultimodalDataset", "SyntheticCohort"]
