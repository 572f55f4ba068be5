"""Multi-band dispatches: the bands layer's one-card forms."""
