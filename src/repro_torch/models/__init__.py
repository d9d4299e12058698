"""Models: transformer layers and the dense LM (training forward, decode)."""
