"""Launchers of the port: ``serve`` (prefill + greedy decode)."""
