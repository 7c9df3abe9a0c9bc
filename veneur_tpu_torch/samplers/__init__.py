"""The wire-facing parse layer: DogStatsD metrics, events and service
checks, SSF sample conversion, and the InterMetric record."""
