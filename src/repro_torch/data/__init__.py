"""The token stream of training.  Port of ``repro.data`` (see
``pipeline.py``)."""

from .pipeline import DataConfig, SyntheticTokenStream

__all__ = ["DataConfig", "SyntheticTokenStream"]
