"""The tensor-parallel layers and their communication ops."""
