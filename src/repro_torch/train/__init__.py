"""Inference surface of the CTDG link pipeline (training comes next)."""
