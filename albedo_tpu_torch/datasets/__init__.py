"""Host-side dataset layer (numpy/pandas): the star matrix, its bucket
layout, the synthetic generators and the train/test split."""

from albedo_tpu_torch.datasets.ragged import Bucket, bucket_rows, grouped_bucket_rows
from albedo_tpu_torch.datasets.split import random_split_by_user, sample_test_users
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.datasets.synthetic import synthetic_stars
from albedo_tpu_torch.datasets.synthetic_tables import synthetic_tables
from albedo_tpu_torch.datasets.tables import RawTables

__all__ = [
    "Bucket",
    "RawTables",
    "StarMatrix",
    "bucket_rows",
    "grouped_bucket_rows",
    "random_split_by_user",
    "sample_test_users",
    "synthetic_stars",
    "synthetic_tables",
]
