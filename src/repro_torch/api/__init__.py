"""Executor capability vocabulary (the rest of ``repro.api`` is not ported yet)."""
