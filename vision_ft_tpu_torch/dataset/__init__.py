from .util import ConcatDataset, DatasetConfig
from .bucket import Bucket, BucketDataset
from .aspect_ratio_bucket import (
    AspectRatioBucket,
    AspectRatioBucketConfig,
    AspectRatioBucketManager,
    generate_buckets,
    print_arb_info,
)

__all__ = [
    "ConcatDataset",
    "DatasetConfig",
    "Bucket",
    "BucketDataset",
    "AspectRatioBucket",
    "AspectRatioBucketConfig",
    "AspectRatioBucketManager",
    "generate_buckets",
    "print_arb_info",
]
