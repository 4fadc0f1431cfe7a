"""Parallelism of the port: the reference's sharding rules over its
production meshes (`sharding`: partition specs of every param, optimizer
state, cache and input leaf; the plans the dry run traces, and the rules
executing over a process group), the collectives that execute them
(`collectives`), and int8 gradient compression (`compression`)."""
