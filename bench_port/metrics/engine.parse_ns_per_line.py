"""Native engine (`native/dogstatsd.cpp` through NativeAggregator.feed):
host time in the engine's `feed` calls, timed by the harness around the
instance's `eng.feed`, over the lines the engine counted."""


def read(ctx):
    d = ctx["delta"]
    if not d.get("feed_ns") or not d["processed"]:
        return None
    return d["feed_ns"] / d["processed"]
