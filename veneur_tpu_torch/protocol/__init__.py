from veneur_tpu_torch.protocol.wire import (  # noqa: F401
    FramingError,
    MAX_SSF_PACKET_LENGTH,
    parse_ssf,
    read_ssf,
    valid_trace,
    write_ssf,
)
