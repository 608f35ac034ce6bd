"""The dry run's roofline on the H100 (the counterpart of
``src/repro/roofline``)."""
from .analysis import HW, collective_bytes, model_flops, roofline_report, roofline_terms

__all__ = ["HW", "collective_bytes", "model_flops", "roofline_report", "roofline_terms"]
