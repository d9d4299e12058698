"""Models: decode-path layers and the dense LM."""
