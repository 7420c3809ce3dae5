"""Offline stylization pipeline: style banks and cross-client transfer."""
