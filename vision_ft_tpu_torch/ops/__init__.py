"""Attention dispatch and the hand-written kernels with their plain versions."""
