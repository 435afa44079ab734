"""Point-axis (sequence-parallel) wrappers: ``sharded_ops``."""
