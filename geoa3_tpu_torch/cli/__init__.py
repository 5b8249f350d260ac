"""Command-line entry points of the port (counterpart of geoa3_tpu/cli)."""
