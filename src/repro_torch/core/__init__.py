"""The paper's primary contribution: a real-time dataflow execution
framework — futures + dynamic task graphs + stateful actors (api),
compiled task graphs with batched one-round dispatch (dag), sharded
control plane (control_plane), hybrid local/global scheduling
with per-actor FIFO mailbox lanes (scheduler), bounded garbage-collected
in-memory object stores (object_store + memory: distributed ref
counting, LRU evict-and-reconstruct), lineage-replay fault tolerance
for tasks and actors (runtime), typed device resources run on
per-node device lanes (devices, runtime), plus baseline executors
(executors) and a cluster-scale discrete-event simulator (simulator).

The port's copy of `repro.core`, plain Python, imported by the port's
compute plane (`repro_torch.compute`), serving tier and streaming plane."""
from repro_torch.core.api import (ActorClass, ActorHandle, ObjectRef,  # noqa: F401
                            RemoteFunction, attach, free, get, init, put,
                            remote, shutdown, wait)
from repro_torch.core import dag  # noqa: F401
from repro_torch.core.backends import (ExecutionBackend,  # noqa: F401
                                 ProcessBackend, ShmRing, ThreadBackend)
from repro_torch.core.chaos import ChaosEvent, FaultInjector  # noqa: F401
from repro_torch.core.control_plane import (ActorSpec, ControlPlane,  # noqa: F401
                                      TaskSpec)
from repro_torch.core.dag import CompiledGraph, GraphNode  # noqa: F401
from repro_torch.core.memory import (MemoryManager,  # noqa: F401
                               ObjectReclaimedError, sizeof)
from repro_torch.core.object_store import (ObjectStore,  # noqa: F401
                                     SharedMemoryStore, SpawnSafetyError)
from repro_torch.core.devices import (DEVICE_RESOURCE_KEYS,  # noqa: F401
                                device_keys)
from repro_torch.core.runtime import (Cluster, DeviceLane,  # noqa: F401
                                FailureDetector, Node)
from repro_torch.core.worker import (ActorContext, GetTimeoutError,  # noqa: F401
                               TaskDeadlineError, TaskError,
                               TaskUnrecoverableError,
                               UnschedulableTaskError)
