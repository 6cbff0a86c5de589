"""Model layers, attention and the decoder LM."""
