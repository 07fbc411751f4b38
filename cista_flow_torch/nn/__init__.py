"""Layers and blocks (``nn.Module``s with the reference's names)."""
