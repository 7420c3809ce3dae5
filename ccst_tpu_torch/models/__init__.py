"""VGG-19 encoder / mirror decoder and weight conversion."""
