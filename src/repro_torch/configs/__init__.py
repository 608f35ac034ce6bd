"""Workload configurations of the port: the paper's datasets
(``cupc_datasets``, for ``launch/pc_run.py --dataset``) and the LM side's
architectures (``--arch <id>`` of ``launch/serve.py`` resolves through
``ARCHS``), copies of the reference's ``src/repro/configs``."""
from .base import LM_SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeCell, SSMConfig, TrainConfig
from .cupc_datasets import CUPC_DATASETS, SCALE_D, SCALE_M, SCALE_N, PCDataset
from .deepseek_v2_236b import CONFIG as deepseek_v2_236b
from .paligemma_3b import CONFIG as paligemma_3b
from .qwen2_15b import CONFIG as qwen2_15b
from .qwen2_moe_a27b import CONFIG as qwen2_moe_a27b
from .qwen3_17b import CONFIG as qwen3_17b
from .rwkv6_3b import CONFIG as rwkv6_3b
from .stablelm_3b import CONFIG as stablelm_3b
from .starcoder2_15b import CONFIG as starcoder2_15b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .zamba2_12b import CONFIG as zamba2_12b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        deepseek_v2_236b,
        qwen2_moe_a27b,
        qwen3_17b,
        qwen2_15b,
        starcoder2_15b,
        stablelm_3b,
        paligemma_3b,
        rwkv6_3b,
        whisper_large_v3,
        zamba2_12b,
    )
}

SHAPES: dict[str, ShapeCell] = {s.name: s for s in LM_SHAPES}

__all__ = ["ARCHS", "SHAPES", "LM_SHAPES", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeCell", "TrainConfig", "CUPC_DATASETS", "PCDataset", "SCALE_D", "SCALE_M",
           "SCALE_N"]
