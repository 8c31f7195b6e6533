"""Process grid, process-group setup, halo exchange and gather."""
