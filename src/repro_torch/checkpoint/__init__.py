"""Atomic checkpoints of the port, in ``repro``'s on-disk layout."""
