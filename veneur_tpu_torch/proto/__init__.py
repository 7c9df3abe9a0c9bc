"""Generated protobuf bindings. ssf_pb2.py is the JAX package's module byte
for byte: both packages register the same ssf.proto in protobuf's default
pool, which accepts an identical descriptor twice and refuses a changed
one."""
