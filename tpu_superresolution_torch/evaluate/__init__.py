"""Whole-image inference of the port (tiling and the forward entry point)."""
