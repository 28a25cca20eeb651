"""Temporal-graph models of the port (1-layer TGAT so far)."""
