"""Circuits, simulator, shift rule and the QuClassi training loop."""
