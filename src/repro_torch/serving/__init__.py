"""Serving layer of the port: the batched engine (`engine`) and the pure
load-trace module (`load`). The front door, replica pool and SLO tracking
come with the runtime slice."""
