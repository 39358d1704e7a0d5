"""Launchers: command-line entry points over the port's public APIs.
Ported so far: `serve` (``python -m repro_torch.launch.serve``) and
`mesh.make_host_mesh` (this rank's place in a `torch.distributed` mesh)."""
