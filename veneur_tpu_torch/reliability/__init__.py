"""Resilience pieces shared by every egress path: RetryPolicy and
CircuitBreaker (policy.py) and the process-global FaultInjector with named
injection points (faults.py). Default no-op."""
