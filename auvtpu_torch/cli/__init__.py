"""Command-line entry points of the port: ``python3 -m auvtpu_torch.cli.<name>``."""
