"""The 2D classification CLI (counterpart of ``co3d_2d``)."""
