"""repro_torch.optim — AdamW over parameter pytrees (PyTorch port)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, cosine_schedule)
