"""Synthetic digit data and the batching pipeline."""
