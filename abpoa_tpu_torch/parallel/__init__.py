"""Batched POA across many independent instances (amplicon/UMI windows):
the unit of work is a batch of instances, run as one device loop."""
from .batch import BatchPOA, batch_msa_from_files  # noqa: F401
