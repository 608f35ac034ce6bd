"""PyTorch/CUDA port of the cuPC reproduction (the JAX package ``repro``
stays the reference). The main path, ``pc(x, alpha)`` with engine
"auto", runs on the CUDA card through four hand-written kernels
(``csrc/``); ``device="cpu"`` runs their plain PyTorch versions."""
from .core.pc import PCRun, pc, pc_from_corr

__all__ = ["PCRun", "pc", "pc_from_corr"]
