"""lux_tpu_torch.analysis.proto against lux_tpu.analysis.proto, on the CPU.

The election model's transition function IS each package's real
StandbyGroup, so the two checkers must walk the same state space and find
the same shortest counterexample: the fenced model checks clean above the
reference's state floor, the unfenced twin yields the split-brain trace,
and its exported FaultPlan is the reference's JSON byte for byte.  Then
the round trip on the port's real Standby threads: the reference's
exported plan reproduces the split brain on the unfenced group, and the
port's fenced group absorbs the same schedule."""
import pytest

from lux_tpu.analysis.proto import check_broken as ref_check_broken
from lux_tpu.analysis.proto import check_protocol as ref_check_protocol
from lux_tpu.analysis.proto.export import export_json as ref_export_json
from lux_tpu_torch.analysis.proto.election_model import ElectionModel, UnfencedStandbyGroup
from lux_tpu_torch.analysis.proto.export import export_faultplan, export_json, trace_seed
from lux_tpu_torch.analysis.proto.mc import Model, check
from lux_tpu_torch.fault.chaos import election_drill
from lux_tpu_torch.fault.plan import FaultPlan
from lux_tpu_torch.serve.autopilot.election import StandbyGroup

#: the reference's floor on the election model's state space
#: (tests/test_luxproto.py: "election": 100)
STATE_FLOOR = 100


def clean():
    return check(ElectionModel(n_standbys=3, fenced=True, max_restarts=1))


def unfenced():
    return check(ElectionModel(n_standbys=2, fenced=False, max_restarts=1))


def test_fenced_election_checks_clean_like_the_reference():
    mine, ref = clean(), ref_check_protocol("election")
    assert mine.ok, mine.violation.format()
    assert (mine.states, mine.transitions, mine.depth) == (ref.states, ref.transitions,
                                                           ref.depth)
    assert mine.states >= STATE_FLOOR and mine.depth > 3
    assert mine.config == ref.config


def test_unfenced_twin_finds_the_reference_counterexample():
    mine, ref = unfenced(), ref_check_broken("election", "unfenced")
    v = mine.violation
    assert v is not None and v.kind == "invariant"
    assert "split brain" in v.message and "incarnation fence" in v.message
    assert v.trace == ref.violation.trace and v.message == ref.violation.message
    assert v.trace[:2] == ("detect(s0)", "claim_win(s0)")
    assert sum(a.startswith("claim_win") for a in v.trace) == 2


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fenced", [True, False])
def test_state_spaces_match_reference(n, fenced):
    from lux_tpu.analysis.proto.election_model import ElectionModel as RefModel
    from lux_tpu.analysis.proto.mc import check as ref_check

    mine = check(ElectionModel(n_standbys=n, fenced=fenced, max_restarts=1))
    ref = ref_check(RefModel(n_standbys=n, fenced=fenced, max_restarts=1))
    assert (mine.ok, mine.states, mine.transitions) == (ref.ok, ref.states, ref.transitions)
    assert mine.summary() == ref.summary()


def test_checker_reports_deadlocks_and_the_state_tripwire():
    class Wedge(Model):
        name = "wedge"

        def initial(self):
            yield 0

        def actions(self, s):
            return [("step", s + 1)] if s < 2 else []

        def invariant(self, s):
            return None

        def accepting(self, s):
            return False

    r = check(Wedge())
    assert r.violation.kind == "deadlock" and r.violation.trace == ("step", "step")
    assert check(ElectionModel(n_standbys=3), max_states=10).violation.kind == "state_space"


def test_export_is_the_reference_json():
    r = unfenced()
    assert export_json(r) == ref_export_json(ref_check_broken("election", "unfenced"))
    plan = export_faultplan(r)
    assert plan.seed == trace_seed(r.violation)
    owners = {rule.point: rule.owner for rule in plan.rules}
    assert owners == {"election.promote": "standby-0", "election.detect": "standby-1"}
    with pytest.raises(ValueError, match="no counterexample"):
        export_faultplan(clean())


def test_unfenced_group_drops_only_the_fence():
    g = UnfencedStandbyGroup()
    g.register(0)
    assert g.claim(0, "inc") is True and g.claim(0, "inc") is True
    f = StandbyGroup()
    f.register(0)
    assert f.claim(0, "inc") is True and f.claim(0, "inc") is False


def _reference_plan():
    return FaultPlan.from_json(ref_export_json(ref_check_broken("election", "unfenced")))


def test_reference_plan_reproduces_split_brain_unfenced():
    rep = election_drill(_reference_plan(), fenced=False)
    assert rep["elections"] == 2, rep
    assert sorted(rep["outcomes"].values()) == ["won", "won"], rep
    assert rep["fired"] > 0


def test_fence_absorbs_the_same_schedule():
    rep = election_drill(_reference_plan(), fenced=True)
    assert rep["elections"] == 1, rep
    assert sorted(rep["outcomes"].values()) == ["adopted", "won"], rep
