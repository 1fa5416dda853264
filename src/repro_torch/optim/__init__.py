"""The optimizer: AdamW with a cosine schedule and global-norm clipping.
Port of ``repro.optim`` (see ``adamw.py``)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule"]
