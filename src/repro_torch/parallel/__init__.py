"""Gradient compression of the port (the reference's `repro.parallel`
without its TPU-mesh sharding rules, which have no counterpart on one
card)."""
