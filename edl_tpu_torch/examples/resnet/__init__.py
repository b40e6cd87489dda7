"""ResNet's elastic train and infer entry (`train`)."""
