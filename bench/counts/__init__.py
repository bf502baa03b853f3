"""Frozen counts and tables of the benchmark (the yardstick)."""
