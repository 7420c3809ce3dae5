"""Offline stylization pipeline (style banks, cross-client transfer), decoder
training and the paper-repro driver."""
