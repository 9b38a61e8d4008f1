"""Sparse-tensor generators and the per-mode sweep schedule."""
