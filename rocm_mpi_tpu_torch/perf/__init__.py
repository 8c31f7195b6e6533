"""The port's traffic model: the analytic A_eff ideals of perf/traffic.py."""
