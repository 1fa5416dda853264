"""Fault-tolerant checkpoints of the train state.  Port of
``repro.checkpoint`` (see ``store.py``)."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
