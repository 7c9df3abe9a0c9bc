"""PyTorch/CUDA port of veneur_tpu: the server daemon and its main path.

DogStatsD datagrams arrive on the server's listeners (server/server.py)
and are parsed, keyed and staged on the host, by the C++ engine
(native/) or the Python parser (samplers/), into one packed i32 buffer
per step, copied to the device once and applied by the fused ingest
kernel (ops/cuda_ingest.py). At the interval boundary the flush worker
gathers live rows and computes t-digest quantiles with the digest kernel
(ops/cuda_digest.py), packed-HLL estimates and the two-float counters;
server/flusher.py labels the result and the sinks (sinks/) take it. The
history tier (history/) keeps past intervals on the device.

The package imports torch, numpy, yaml, google.protobuf and the standard
library. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; on CPU tensors the kernel wrappers run their
plain PyTorch versions.
"""

__version__ = "0.1.0"
