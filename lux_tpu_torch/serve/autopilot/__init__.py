"""lux_tpu_torch.serve.autopilot — the self-driving fleet.

Counterpart of ``lux_tpu.serve.autopilot`` (a copy: the port imports
nothing of the reference; a policy's JSON is the reference's).  The
closed control loop over the serving fleet's own telemetry:

* :mod:`.policy` — admission policy as JSON-round-trip data: which
  degraded mode (serve / queue / stale_degrade / shed) each SLO
  verdict buys, evaluated on the controller's heartbeat cadence;
* :mod:`.autoscaler` — SLO- and occupancy-driven scale decisions with
  hysteresis, cooldown and a rebalance-preview move budget;
* :mod:`.election` — standby controllers that detect incumbent death
  and run a deterministic, incarnation-fenced election through
  ``promote_live_controller``;
* :mod:`.subscribe` — standing-query subscriptions: register once,
  get pushed every refreshed answer with the generation tag as
  cursor, surviving controller elections via hub rebind.

Every autonomous action (scale, elect, promote, policy switch,
subscription push) emits a causally-linked dtrace span on a keyed
incident trace, so a stitched log renders one timeline per incident.

Exports resolve LAZILY (PEP 562, same contract as ``lux_tpu_torch.serve``):
``election``/``policy`` are stdlib only, and the protocol tier
(``lux_tpu_torch.analysis.proto.election_model``) model-checks the REAL
``StandbyGroup``.
"""
_EXPORTS = {
    "Autoscaler": "lux_tpu_torch.serve.autopilot.autoscaler",
    "AutoscalerConfig": "lux_tpu_torch.serve.autopilot.autoscaler",
    "Standby": "lux_tpu_torch.serve.autopilot.election",
    "StandbyGroup": "lux_tpu_torch.serve.autopilot.election",
    "live_promoter": "lux_tpu_torch.serve.autopilot.election",
    "MODES": "lux_tpu_torch.serve.autopilot.policy",
    "AdmissionPolicy": "lux_tpu_torch.serve.autopilot.policy",
    "PolicyError": "lux_tpu_torch.serve.autopilot.policy",
    "PolicyRule": "lux_tpu_torch.serve.autopilot.policy",
    "default_fleet_policy": "lux_tpu_torch.serve.autopilot.policy",
    "Subscription": "lux_tpu_torch.serve.autopilot.subscribe",
    "SubscriptionClosed": "lux_tpu_torch.serve.autopilot.subscribe",
    "SubscriptionHub": "lux_tpu_torch.serve.autopilot.subscribe",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
