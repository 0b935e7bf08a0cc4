"""repro_torch.launch — entry points (the serving engine)."""
