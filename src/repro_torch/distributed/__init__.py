"""Checkpoints of the port (``checkpoint``); meshes and collectives wait
for the multi-GPU slices."""
