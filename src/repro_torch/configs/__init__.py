"""Workload configurations of the port: the paper's datasets
(``cupc_datasets``), for ``launch/pc_run.py --dataset``."""
from .cupc_datasets import CUPC_DATASETS, SCALE_D, SCALE_M, SCALE_N, PCDataset

__all__ = ["CUPC_DATASETS", "PCDataset", "SCALE_D", "SCALE_M", "SCALE_N"]
