"""The paper's own workload configurations (a copy of
``src/repro/configs/cupc_datasets.py``): the six gene-expression
benchmarks of Table 1 and the §5.6 synthetic scalability grids. The
expression matrices are not bundled; each dataset is a Gaussian-DAG
stand-in with the published (n, m) and a density chosen for the paper's
regime."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PCDataset:
    name: str
    n: int  # variables
    m: int  # samples
    density: float = 0.1  # edge probability of the synthetic stand-in
    alpha: float = 0.01
    max_level: int | None = None


# Table 1 of the paper (n, m published; density of the synthetic stand-in)
CUPC_DATASETS = {
    "NCI-60": PCDataset("NCI-60", 1190, 47, 0.02),
    "MCC": PCDataset("MCC", 1380, 88, 0.02),
    "BR-51": PCDataset("BR-51", 1592, 50, 0.02),
    "S.cerevisiae": PCDataset("S.cerevisiae", 5361, 63, 0.01),
    "S.aureus": PCDataset("S.aureus", 2810, 160, 0.01),
    "DREAM5-Insilico": PCDataset("DREAM5-Insilico", 1643, 850, 0.05),
}

# §5.6 scalability grids
SCALE_N = (1000, 2000, 3000, 4000)  # d = 0.1, m = 10000
SCALE_M = (2000, 4000, 6000, 8000, 10000)  # n = 1000, d = 0.1
SCALE_D = (0.1, 0.2, 0.3, 0.4, 0.5)  # n = 1000, m = 10000
