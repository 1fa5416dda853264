"""The optimizer: AdamW with a cosine schedule and global-norm clipping.
Port of ``repro.optim`` (see ``adamw.py``), and the int8 error-feedback
compression of a cross-replica reduction (``compress.py``)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule, opt_pspecs

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "opt_pspecs"]
