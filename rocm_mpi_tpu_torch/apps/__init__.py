"""Command-line apps of the port (run with `python -m`)."""
