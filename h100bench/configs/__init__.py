"""Model configurations: `<name>.json` (sizes, the port's class and loss)
beside `<name>.py` (the plain PyTorch reference of that model)."""
