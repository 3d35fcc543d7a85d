"""repro_torch.launch — command-line entry points (PyTorch port)."""
