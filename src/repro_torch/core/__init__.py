"""The PyTorch port of the CFA stack (``repro_torch.core.cfa``)."""
