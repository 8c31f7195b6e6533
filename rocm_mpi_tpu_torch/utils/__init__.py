"""Device policy and timing utilities."""
