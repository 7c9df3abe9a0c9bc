"""Flush phase `frame_build`: labelling
(server/flusher.py generate_frame). The Server's
veneur.flush.phase_duration_ns{phase=frame_build} over the window, a flush
(sum over count)."""


def read(ctx):
    count, total_ns = ctx["delta"]["phases"].get("frame_build", (0, 0))
    if not count:
        return None
    return total_ns / count / 1e6
