"""Resilience pieces: RetryPolicy and CircuitBreaker (policy.py) for every
egress path, the process-global FaultInjector with named injection points
(faults.py), the forward spill (spill.py), and the overload controller
(overload.py) with multi-tenant fairness under it (tenancy.py) for the
paths in. Default no-op."""
