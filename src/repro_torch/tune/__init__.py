"""Knobs of the offline plan (the tuner itself is a later slice)."""
