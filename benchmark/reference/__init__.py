"""Plain references of the benchmark's configurations, one module each."""
