"""Offline visualization: frame overlays and the top-down map render."""
