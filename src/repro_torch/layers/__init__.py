"""Parameter specs and the basic layers (dense, embed, norms, rope,
activations)."""
