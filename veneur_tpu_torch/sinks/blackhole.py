"""No-op sink (reference sinks/blackhole/blackhole.go) — the benchmark and
test target (BASELINE config 1 flushes to blackhole)."""

from veneur_tpu_torch.sinks.base import MetricSink, SpanSink


class BlackholeMetricSink(MetricSink):
    name = "blackhole"

    def __init__(self):
        self.frames_rows = 0  # benchmark introspection

    def flush(self, metrics):
        pass

    def flush_frame(self, frame):
        self.frames_rows += len(frame)


class BlackholeSpanSink(SpanSink):
    name = "blackhole"

    def ingest(self, span):
        pass
