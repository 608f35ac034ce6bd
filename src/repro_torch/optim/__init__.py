from .adamw import adamw_init, adamw_update, clip_by_global_norm, warmup_cosine  # noqa: F401
from .compress import compress_int8, decompress_int8  # noqa: F401
