"""Checkpoint conversion tools of the port (``tools/checkpoint`` counterpart)."""
