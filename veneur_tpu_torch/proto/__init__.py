"""Generated protobuf bindings, the JAX package's modules with the port's
imports. Both packages register the same .proto files in protobuf's
default pool, which accepts an identical descriptor twice and refuses a
changed one, so the serialized descriptors are kept byte for byte:
ssf_pb2.py and tdigestpb_pb2.py are copied whole, and metricpb_pb2.py and
forwardrpc_pb2.py differ only in the line that imports their dependency
from this package."""
