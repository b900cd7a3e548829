"""Frame batching and the texture training step of the PyTorch port."""
