"""Tests of the benchmark harness, on the CPU:

    python -m pytest stencil_bench/tests -q

Tests marked `card` need an NVIDIA GPU; each decides inside itself
whether one is present and skips without it. On the card:

    python -m pytest stencil_bench/tests -q -m card
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")
