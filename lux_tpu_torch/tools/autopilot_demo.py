"""autopilot_demo — watch the fleet fly itself, end to end.

Counterpart of the reference's ``tools/autopilot_demo.py``.  Runs the FULL
autonomous loop (``lux_tpu_torch/fault/chaos.autopilot_soak``) with
tracing on, its replicas on ``--device`` (default ``cuda``; without a
card that raises — pass ``--device cpu``), and narrates what the pilot
did:

1. a load ramp above the per-worker knee trips the **Autoscaler** into
   a previewed, cooldown-gated scale-up (a new replica spawned, joined,
   rebalanced onto the ring);
2. the incumbent controller is killed — a **Standby** detects the
   silence, wins the incarnation-fenced election and runs
   ``promote_live_controller`` unattended, with the standing-query
   **subscription** still delivering across the failover (hub rebind);
3. fat churn batches overflow the delta capacity into an escalated
   fleet-wide **compaction**;

with zero acked-write loss and bitwise post-recovery answers asserted
throughout.  Every autonomous action lands as a span on a keyed
incident trace; the demo prints each incident's trace id and the event
log's run directory.

Usage:
  python -m lux_tpu_torch.tools.autopilot_demo [--seed 0] [--steps 4]
      [--scale 7] [--cap 48] [--device cuda|cpu] [--json]
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4,
                    help="ramp-phase write/read/tick steps")
    ap.add_argument("--scale", type=int, default=7, help="rmat scale")
    ap.add_argument("--cap", type=int, default=48,
                    help="delta capacity (small -> compaction fires)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replicas' engines run (default cuda; "
                         "without a card, cuda raises)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw soak report as JSON")
    args = ap.parse_args(argv)

    from lux_tpu_torch import obs
    from lux_tpu_torch.fault.chaos import autopilot_soak
    from lux_tpu_torch.obs import dtrace
    from lux_tpu_torch.obs.dtrace import _hex_hash
    from lux_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises before any work
    rec = obs.Recorder()
    obs.install(rec)
    dtrace.set_enabled(True)
    try:
        report = autopilot_soak(args.seed, steps=args.steps,
                                scale=args.scale, cap=args.cap,
                                device=device)
    finally:
        dtrace.set_enabled(None)

    if args.json:
        print(json.dumps(report, default=str))
        return 0

    keys = report["incident_keys"]
    print(f"autopilot soak (seed {args.seed}, {device}) — the fleet flew "
          "itself:")
    print(f"  writes admitted        : {report['writes']} "
          f"(generation {report['generation']}, zero acked loss)")
    print(f"  reads (bitwise checked): {report['reads']}")
    print(f"  scale-ups              : {report['scale_ups']}")
    print(f"  elections              : {report['elections']} "
          f"(standby {report['winner']} won, incarnation-fenced)")
    print(f"  compactions (overflow) : {report['compactions']}")
    print(f"  subscription deliveries: {len(report['sub_delivered'])} "
          f"(generations {report['sub_delivered']}) — survived the "
          "failover")
    print("\nincident traces (one stitched timeline per incident):")
    rows = [("election", keys["election"])] + [
        (f"scale #{i + 1}", k)
        for i, k in enumerate(keys["scale"])]
    for label, key in rows:
        print(f"  {label:<12} key={key}  trace={_hex_hash(f'lux:{key}', 8)}")
    print(f"\nevent log: {rec.run_dir()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
