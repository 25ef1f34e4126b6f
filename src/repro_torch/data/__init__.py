"""Data substrate: synthetic dataset generators + sharded input pipeline."""
