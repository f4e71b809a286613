"""Models: configuration, layers and the dense transformer."""
