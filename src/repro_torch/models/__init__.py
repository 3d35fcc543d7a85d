"""repro_torch.models — the decoder LM (PyTorch port of ``repro.models``)."""
