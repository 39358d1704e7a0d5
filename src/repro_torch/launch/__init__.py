"""Launchers: command-line entry points over the port's public APIs.
Ported so far: `serve` (``python -m repro_torch.launch.serve``)."""
