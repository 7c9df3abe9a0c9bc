"""The global tier's receive side: local→global sketch forwarding over
gRPC and HTTP (reference forwardrpc/, importsrv/ — SURVEY §2.4)."""
