"""Metrics logging, checkpoints, profiling, SWA, plots and round exports."""
