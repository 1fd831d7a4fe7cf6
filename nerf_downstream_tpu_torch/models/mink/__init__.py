"""Sparse-voxel networks over the windowed conv path."""
