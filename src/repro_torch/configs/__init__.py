"""Workload configurations (the QuClassi paper settings)."""
