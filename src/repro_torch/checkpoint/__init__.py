"""Pytree checkpoints in the reference's ``.npz`` format."""
from repro_torch.checkpoint.checkpoint import load, save

__all__ = ["load", "save"]
