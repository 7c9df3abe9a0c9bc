from veneur_tpu_torch.trace.client import (  # noqa: F401
    ChannelBackend,
    Client,
    PacketBackend,
    StreamBackend,
)
from veneur_tpu_torch.trace.tracer import Span, Tracer  # noqa: F401
