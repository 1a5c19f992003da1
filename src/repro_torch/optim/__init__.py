"""Functional optimizers over dictionaries of tensors."""
