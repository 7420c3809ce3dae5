"""Metrics logging, checkpoints and profiling of the training stage."""
