"""Checkpointing of the port: the reference's layout and leaf paths."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
