"""Trace-driven fleet observatory: journal replay + discrete-event simulation.

The port's copy of ``unionml_tpu/sim/`` (host only: no device work). Its
policies are the port's own ``Router``, ``SLOScheduler``, ``SLOTracker`` and
``block_demand``; its journal is the one the port's ``Telemetry`` writes.

The serving stack journals every completed request (``telemetry.py``,
schema v2) and exposes its scheduling policy as engine-free pure host
objects (:class:`~unionml_tpu_torch.serving.scheduler.SLOScheduler`,
:class:`~unionml_tpu_torch.serving.fleet.Router`, the paged-KV block-demand
arithmetic in ``continuous.block_demand``). This package closes the loop:
a deterministic discrete-event simulator drives those SAME policy objects
with a virtual clock, so capacity questions ("how many replicas for a
million users at this SLO?", "does the autoscaler beat static
provisioning?") are answered by the production code paths, not a
re-implementation that would drift.

Two input modes:

- **Journal replay** (:func:`replay_journal`): re-derive every policy
  counter (sheds by reason, preemptions, deadline misses, failover
  adoptions) and the SLO good/total ledger from a recorded journal alone,
  for bit-for-bit validation against the live process that wrote it.
- **Synthetic traces** (:func:`generate_requests`): seeded million-user
  workloads — diurnal rate curves, bursts, heavy-tail lengths, hot-prefix
  skew, session churn, replica-death schedules — fed through
  :class:`FleetSimulator`.

Costs (prefill / inter-token / dispatch latency) come from a
:class:`CostModel`, fit from a real journal with :func:`fit_cost_model`
so the simulator's clock advances at measured speeds.
"""

from unionml_tpu_torch.sim.autoscaler import Autoscaler, AutoscalerConfig
from unionml_tpu_torch.sim.cost_model import CostModel, fit_cost_model
from unionml_tpu_torch.sim.core import FleetSimulator, SimConfig, replay_journal
from unionml_tpu_torch.sim.journal import JournalRecord, load_journal, parse_journal_record
from unionml_tpu_torch.sim.traces import (
    ReplicaDeath,
    SimRequest,
    SyntheticConfig,
    generate_requests,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "CostModel",
    "FleetSimulator",
    "JournalRecord",
    "ReplicaDeath",
    "SimConfig",
    "SimRequest",
    "SyntheticConfig",
    "fit_cost_model",
    "generate_requests",
    "load_journal",
    "parse_journal_record",
    "replay_journal",
]
