"""Core numerical ops: AdaIN statistics and streaming Welford moments."""
