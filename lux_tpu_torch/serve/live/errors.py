"""The live-serving protocol surface: exceptions + reason constants.

Counterpart of ``lux_tpu.serve.live.errors`` (a copy: the port imports
nothing of the reference; the spellings are the reference's, since they
travel on the wire).  These are the types/strings the generation-line
protocol SPEAKS — a replica refusing an out-of-sequence delta, a
controller permanently refusing a worker at handshake.  They live in
their own stdlib-only module (not ``replica.py``, which imports the
torch-backed overlay machinery) so the protocol model tier
(``lux_tpu_torch.analysis.proto``) imports the real types without torch.
"""
from __future__ import annotations

#: the three PERMANENT ``add_worker`` refusal reasons
#: (``WorkerRefusedError.kind``): takeover()'s retry loop treats any
#: other failure as transient; these can never heal by re-helloing.
REFUSE_STATIC = "static"            # worker serves no generation tags
REFUSE_AHEAD = "ahead_of_journal"   # split-brain guard: wrong history
REFUSE_PRE_EPOCH = "pre_epoch"      # compacted past: restart from snap

REFUSAL_REASONS = (REFUSE_STATIC, REFUSE_AHEAD, REFUSE_PRE_EPOCH)


class GenerationGap(RuntimeError):
    """A delta arrived out of sequence: the replica holds ``have``, the
    batch claims ``want``.  The controller answers with the catch-up
    stream (batches have+1..)."""

    def __init__(self, have: int, want: int):
        super().__init__(
            f"replica is at generation {have}, delta claims {want} — "
            "re-sync from the controller journal")
        self.have = int(have)
        self.want = int(want)
