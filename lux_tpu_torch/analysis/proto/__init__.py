"""Exhaustive protocol model checking for the fleet's controller election.

Counterpart of the election part of ``lux_tpu.analysis.proto``: the
explicit-state checker (``mc.py``), the election model whose transition
function IS the port's real :class:`StandbyGroup`
(``election_model.py``), and the counterexample -> FaultPlan export that
``fault.chaos.election_drill`` replays against real Standby threads
(``export.py``).  The clean model must check clean; its broken twin (the
fence dropped) must produce a counterexample.

Pure stdlib + the stdlib-only election and fault-plan modules.
"""
