"""The two-phase publish protocol surface: token format + refusal
strings shared by the controller (``fleet/controller.py`` republish)
and the worker (``fleet/worker.py`` prepare/commit/discard).

Counterpart of ``lux_tpu.serve.fleet.pubproto`` (a copy: the port
imports nothing of the reference; tokens and refusal strings are
spelled the same, so a protocol model checked against the reference's
spellings holds for the port's).

The protocol, for reference (checked exhaustively by the model):

1. controller mints ``publish_token(incarnation, rid)`` — incarnation-
   scoped, so tokens from a dead controller can never collide with its
   successor's;
2. ``prepare {token}`` fans out; the worker records the token FIRST
   (latest prepare wins), builds the staged cache, and re-checks the
   token before staging — a prepare that lost the race must not stage;
3. any prepare failure → ``discard`` fan-out (clears staged + token,
   strands in-flight prepares);
4. all-staged → ``commit {token}``: the worker swaps ONLY on an exact
   token match (:func:`token_mismatch` is the refusal), so a commit can
   never install a cache staged for a different republish;
5. a successor controller re-arms worker token state by discarding
   before its own republish.
"""
from __future__ import annotations

from typing import Optional


def publish_token(incarnation: str, rid) -> str:
    """The republish barrier token: incarnation-fenced + per-request
    unique within that incarnation.  ``rid`` is the controller's
    request id VERBATIM (the wire format is ``pub-{inc}-r{seq}``)."""
    return f"pub-{incarnation}-{rid}"


#: commit refusal when no prepare staged anything (or a discard ran)
ERR_NOTHING_STAGED = "nothing staged"

#: prepare refusal when a discard / newer prepare won the token race
ERR_PREPARE_SUPERSEDED = "prepare superseded/discarded"


def token_mismatch(staged: Optional[str], want: Optional[str]) -> str:
    """The commit refusal for a staged cache belonging to a DIFFERENT
    republish than the one committing."""
    return (f"staged token {staged!r} does not match "
            f"commit token {want!r}")
