"""Checkpoints of the port (``checkpoint``: synchronous and background
writes); meshes and collectives wait for the multi-GPU slices."""
