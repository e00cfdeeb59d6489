"""Batched multi-tenant solve engine on one device: many concurrent ABO
jobs through row-compacted sweeps over block-paged lane pools.

Port of :mod:`repro.engine` (see ``batched`` for the pool layout and
``scheduler.SolveEngine`` for the step loop). A job pays for its true
``ceil(n / block)`` blocks, jobs of every n share one family pool, and a
job's fun/x are bit-identical to the port's ``abo_minimize`` at any
layout. Pool memory is elastic; failed lanes quarantine to FAILED;
admission control rejects with typed errors; the fault-injection registry
arms failpoints for chaos tests; snapshots, the journal and
``SolveEngine.resume`` make the engine's state durable across a kill.
Sharded pools and spanning lanes are not ported yet (ROADMAP.md, queue
1)."""
from repro_torch.engine.faults import (NULL_FAULTS, Fault, FaultRegistry,
                                       InjectedFault, parse_fault_spec)
from repro_torch.engine.jobs import (CANCELLED, DONE, FAILED, QUEUED,
                                     RUNNING, JobSpec, JobState)
from repro_torch.engine.scheduler import (AdmissionError, LanePool,
                                          MemoryBudgetError, QueueFullError,
                                          SolveEngine)
from repro_torch.engine.service import SolveService

__all__ = ["JobSpec", "JobState", "LanePool", "SolveEngine", "SolveService",
           "QUEUED", "RUNNING", "DONE", "CANCELLED", "FAILED",
           "AdmissionError", "QueueFullError", "MemoryBudgetError",
           "Fault", "FaultRegistry", "InjectedFault", "NULL_FAULTS",
           "parse_fault_spec"]
