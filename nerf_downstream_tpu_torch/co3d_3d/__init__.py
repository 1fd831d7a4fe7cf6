"""Command-line entry points of the port (counterparts of ``co3d_3d/``)."""
