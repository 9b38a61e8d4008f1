"""Atomic on-disk checkpoints of trees of tensors."""
