"""Serving entry points of the port: prefill and decode steps, and the
``python -m repro_torch.launch.serve`` command."""
