"""Shared helpers: two-float numerics and hashing for the host and device
code, the statsd line emitter, crash reporting and atomic file appends."""
