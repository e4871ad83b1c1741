from .bags import DEFAULT_BUCKETS, bucket_for, pad_bag

__all__ = ["DEFAULT_BUCKETS", "bucket_for", "pad_bag"]
