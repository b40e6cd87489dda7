"""MNIST's train and infer entry (`train`)."""
