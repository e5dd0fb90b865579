"""The flight recorder's host half: one append-only JSONL event log per run.

Counterpart of ``lux_tpu.obs.recorder`` (a copy: the port imports
nothing of the reference).  The event schema, the environment names and
the directory contract are the reference's, so the reference's
``tools/luxview.py`` renders a log this package wrote.  Begin events
reach the disk before the work they cover runs, so a process killed
mid-step leaves an unfinished span, not a blank file.

Design constraints, in order:

* pure stdlib: importing this module pulls in neither torch nor numpy;
* always on, never load-bearing: a full disk, an untrusted log
  directory or LUX_OBS=0 degrade to in-memory aggregation only; no
  caller branches on recorder health, and a recorder failure never fails
  a run;
* cheap: one span is two dict->JSON lines on a buffered file plus a
  locked counter bump; the hot loops keep their per-iteration telemetry
  on the device (lux_tpu_torch.obs.ring) and the recorder sees only the
  one fetch at the end of a run.

Event vocabulary (one JSON object per line):

  {"e":"m", "run":..,"pid":..,"wall":..,"mono":..,"argv":[..]}   file meta
  {"e":"b", "n":name,"s":sid,"p":parent_sid|null,"t":mono,"a":{..}}
  {"e":"e", "s":sid,"t":mono,"ok":bool,"a":{..}}                 span end
  {"e":"p", "n":name,"t":mono,"a":{..}}                          point

Span ids are "<pid>-<token>-<counter>" (the token is random per process:
a long session recycles pids, and two processes issuing "1234-1" would
let a later begin overwrite an earlier span when the logs are merged), so
events from several processes of one run (a driver and the apps it
spawns) merge into one timeline: CLOCK_MONOTONIC is system-wide on Linux,
so ``t`` values of different processes compare directly, and the meta
event's (wall, mono) pair anchors them to calendar time.

The run directory is vetted like the plan cache
(ops/expand._cache_dir_trusted): 0o700, owned by this uid, no symlink.
"""
from __future__ import annotations

import binascii
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Optional

#: LUX_OBS=0 disables FILE writes (in-memory span totals still
#: aggregate: readers of ``totals()`` must never depend on the log
#: directory's health)
ENABLE_ENV = "LUX_OBS"
DIR_ENV = "LUX_OBS_DIR"
RUN_ENV = "LUX_OBS_RUN_ID"
#: retention: the recorder is always-on, so without a bound the root
#: accumulates one run dir per app/serve/test invocation until the
#: disk fills — and a full disk silently disables the post-mortem
#: logging the feature exists for.  Keep the newest N run dirs (the plan
#: cache's analogous bounded contract); <= 0 disables the sweep.
KEEP_ENV = "LUX_OBS_KEEP"
DEFAULT_KEEP = 64
#: never sweep a dir whose newest file was written in the last hour —
#: a live run beyond the keep horizon must not lose its log mid-write
SWEEP_MIN_AGE_S = 3600.0


def default_root() -> str:
    """Per-user event-log root, the plan cache's sibling."""
    uid = os.getuid() if hasattr(os, "getuid") else "na"
    return os.environ.get(DIR_ENV) or os.path.join(
        tempfile.gettempdir(), f"lux_obs_{uid}")


def _dir_trusted(path: str) -> bool:
    """Create (0o700) and vet an event-log dir: refuse symlinks, foreign
    owners, and group/other access — same contract as the plan cache."""
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        st = os.lstat(path)
    except OSError:
        return False
    if os.path.islink(path) or not os.path.isdir(path):
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    if st.st_mode & 0o077:
        try:  # repair a pre-existing loose dir we own
            os.chmod(path, 0o700)
        except OSError:
            return False
    return True


def _sweep_old_runs(root: str, current_dir: str) -> None:
    """Delete the oldest run dirs beyond the keep horizon (newest file
    mtime orders them); the current run and anything written within
    SWEEP_MIN_AGE_S are never touched.  All failures are absorbed —
    retention, like everything else here, can never fail a run."""
    raw = os.environ.get(KEEP_ENV, "")
    try:
        keep = int(raw) if raw.strip() else DEFAULT_KEEP
    except ValueError:
        keep = DEFAULT_KEEP
    if keep <= 0:
        return
    try:
        cur = os.path.realpath(current_dir)
        now = time.time()
        entries = []
        with os.scandir(root) as it:
            for de in it:
                if not de.is_dir(follow_symlinks=False):
                    continue
                if os.path.realpath(de.path) == cur:
                    continue
                try:
                    newest = de.stat(follow_symlinks=False).st_mtime
                    with os.scandir(de.path) as files:
                        for f in files:
                            try:
                                st = f.stat(follow_symlinks=False)
                            except OSError:
                                continue
                            newest = max(newest, st.st_mtime)
                except OSError:
                    continue
                entries.append((newest, de.path))
        entries.sort(reverse=True)
        # the current run dir occupies one keep slot
        for newest, path in entries[max(keep - 1, 0):]:
            if now - newest < SWEEP_MIN_AGE_S:
                continue
            shutil.rmtree(path, ignore_errors=True)
    except OSError:
        pass


def new_run_id() -> str:
    """Collision-proof human-sortable run id.  Wall clock + pid + random
    suffix; never feeds results or cache keys (the wall clock stays out
    of engine code — this is the metadata layer)."""
    stamp = time.strftime("%Y%m%d_%H%M%S")
    rand = binascii.hexlify(os.urandom(3)).decode()
    return f"{stamp}_{os.getpid()}_{rand}"


class Span:
    """One live span.  Use via ``Recorder.span`` / module-level ``span``:

        with span("plan.build", parts=4) as sp:
            ...
            sp.set(bytes=n)        # attrs attached to the END event
        sp.dur                     # seconds, available after exit
    """

    __slots__ = ("_rec", "name", "sid", "parent", "attrs", "_end_attrs",
                 "t0", "dur", "ok")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._end_attrs: dict = {}
        self.sid = ""
        self.parent: Optional[str] = None
        self.t0 = 0.0
        self.dur = 0.0
        self.ok = True

    def set(self, **attrs) -> "Span":
        self._end_attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._rec._begin(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.ok = exc_type is None
        self._rec._end(self)
        return False


class Recorder:
    """Process-wide flight recorder; one JSONL file per (run, process).

    Thread-safe: the span stack is per-thread (nesting follows each
    thread's own call structure), the file and the aggregation table are
    lock-guarded.  All failures are absorbed — a recorder can degrade to
    memory-only but can never raise into the instrumented code path.
    """

    def __init__(self, run_id: Optional[str] = None,
                 root: Optional[str] = None,
                 enabled: Optional[bool] = None,
                 clock=time.monotonic):
        self.run_id = (run_id or os.environ.get(RUN_ENV) or new_run_id())
        self.root = root or default_root()
        if enabled is None:
            enabled = os.environ.get(ENABLE_ENV, "1") != "0"
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._file = None
        self._file_failed = False
        self._swept = False
        # pid reuse over a long session must not collide sids (luxview
        # merges all of a run's files into one flat span table)
        self._sid_prefix = (
            f"{os.getpid()}-{binascii.hexlify(os.urandom(2)).decode()}")
        self._next_sid = 0
        #: span name -> [count, total_seconds]; the plan cache's
        #: ``plan_stats_snapshot`` seconds are views over the same span
        #: durations (no drift between the two)
        self._totals: dict[str, list] = {}
        self.log_path: Optional[str] = None

    # -- file plumbing --------------------------------------------------

    def run_dir(self) -> str:
        return os.path.join(self.root, self.run_id)

    def _open(self):
        """Lazy line-buffered open; one failure disables file output for
        the process (memory aggregation continues)."""
        if self._file is not None or self._file_failed or not self.enabled:
            return self._file
        d = self.run_dir()
        if not _dir_trusted(self.root) or not _dir_trusted(d):
            self._file_failed = True
            return None
        if not self._swept:
            self._swept = True
            _sweep_old_runs(self.root, d)
        try:
            path = os.path.join(d, f"events-{os.getpid()}.jsonl")
            # block-buffered, flushed explicitly: span begins/points
            # flush (the crash-safety contract — a killed process must
            # leave its OPEN span on disk), while retroactive spans
            # (emit_span — the work already finished) ride the buffer
            # so high-rate distributed tracing is not one syscall per
            # event
            self._file = open(path, "a", buffering=8192,
                              encoding="utf-8")
            # buffered tail events must survive a normal exit even when
            # nobody closes the recorder (CLI tools, spawned workers)
            import atexit

            atexit.register(self.close)
            self.log_path = path
            self._file.write(json.dumps({
                "e": "m", "run": self.run_id, "pid": os.getpid(),
                "wall": time.time(), "mono": self.clock(),
                "argv": sys.argv[:4],
            }, default=str) + "\n")
        except OSError:
            self._file_failed = True
            self._file = None
        return self._file

    def _write(self, obj: dict) -> None:
        self._write_lines((obj,), flush=True)

    def _write_lines(self, objs, flush: bool = False) -> None:
        try:
            # serialize OUTSIDE the lock: the recorder is process-wide
            # and high-rate tracing writes from every serving thread —
            # holding the lock across json.dumps serializes them all
            text = "".join(json.dumps(o, separators=(",", ":"),
                                      default=str) + "\n"
                           for o in objs)
        except (ValueError, TypeError):
            text = None
        with self._lock:
            f = self._open()
            if f is None:
                return
            try:
                if text is None:
                    raise ValueError("unserializable event")
                f.write(text)
                if flush:
                    f.flush()
            except (OSError, ValueError):
                self._file_failed = True
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def flush(self) -> None:
        """Push buffered (retroactive-span) events to disk — readers
        of a LIVE log (tests, a mid-run luxstitch) call this; close()
        flushes implicitly."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- spans ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _begin(self, sp: Span) -> None:
        with self._lock:
            self._next_sid += 1
            sp.sid = f"{self._sid_prefix}-{self._next_sid}"
        st = self._stack()
        sp.parent = st[-1] if st else None
        st.append(sp.sid)
        sp.t0 = self.clock()
        ev = {"e": "b", "n": sp.name, "s": sp.sid, "p": sp.parent,
              "t": sp.t0}
        if sp.attrs:
            ev["a"] = sp.attrs
        self._write(ev)

    def _end(self, sp: Span) -> None:
        t1 = self.clock()
        sp.dur = t1 - sp.t0
        st = self._stack()
        if st and st[-1] == sp.sid:
            st.pop()
        elif sp.sid in st:  # mis-nested exit: drop through to it
            del st[st.index(sp.sid):]
        if sp.ok:
            # only completed spans feed the aggregate: a failed
            # plan.load (rebuilt under plan.build) must not drift the
            # totals from the plan cache's own seconds.
            # Failure timings stay in the event log, ok=false.
            with self._lock:
                tot = self._totals.setdefault(sp.name, [0, 0.0])
                tot[0] += 1
                tot[1] += sp.dur
        ev = {"e": "e", "s": sp.sid, "t": t1, "ok": sp.ok}
        if sp._end_attrs:
            ev["a"] = sp._end_attrs
        self._write(ev)

    def point(self, name: str, **attrs) -> None:
        ev = {"e": "p", "n": name, "t": self.clock()}
        if attrs:
            ev["a"] = attrs
        self._write(ev)

    def emit_span(self, name: str, t0: float, t1: float, ok: bool = True,
                  attrs: Optional[dict] = None,
                  end_attrs: Optional[dict] = None) -> str:
        """Record a span RETROACTIVELY — begin+end in one call, never
        touching the per-thread nesting stack.  This exists for work
        whose begin and end happen on different threads (a fleet query
        submitted on the caller's thread resolves on the connection
        reader): a stack-based ``span()`` begun there would become the
        phantom parent of every later span on the submitting thread.
        The two events carry the timestamps the caller measured; the
        aggregate totals count it like any completed span.  Returns the
        minted sid (the distributed-tracing layer links across
        processes via its own span attrs, not this id)."""
        with self._lock:
            self._next_sid += 1
            sid = f"{self._sid_prefix}-{self._next_sid}"
            if ok:
                tot = self._totals.setdefault(name, [0, 0.0])
                tot[0] += 1
                tot[1] += float(t1) - float(t0)
        b = {"e": "b", "n": name, "s": sid, "p": None, "t": float(t0)}
        if attrs:
            b["a"] = dict(attrs)
        e = {"e": "e", "s": sid, "t": float(t1), "ok": bool(ok)}
        if end_attrs:
            e["a"] = dict(end_attrs)
        # both halves are already known and the work already ENDED, so
        # one UNFLUSHED buffered write — per-event write syscalls are
        # the dominant cost of high-rate tracing, and a crash loses
        # nothing a post-mortem needs (open spans always flush)
        self._write_lines((b, e))
        return sid

    # -- aggregation (the "one clock" view) -----------------------------

    def total_seconds(self, name: str) -> float:
        with self._lock:
            tot = self._totals.get(name)
            return tot[1] if tot else 0.0

    def total_count(self, name: str) -> int:
        with self._lock:
            tot = self._totals.get(name)
            return tot[0] if tot else 0

    def totals(self, prefix: str = "") -> dict:
        """{name: (count, seconds)} snapshot for names under prefix."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._totals.items()
                    if k.startswith(prefix)}

    def reset_totals(self, prefix: str = "") -> None:
        with self._lock:
            for k in list(self._totals):
                if k.startswith(prefix):
                    del self._totals[k]


# ---------------------------------------------------------------------------
# process-wide singleton + module-level convenience API
# ---------------------------------------------------------------------------

_RECORDER: Optional[Recorder] = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> Recorder:
    """The process recorder (created on first use, honoring
    LUX_OBS_RUN_ID / LUX_OBS_DIR / LUX_OBS)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = Recorder()
        return _RECORDER


def install(rec: Optional[Recorder]) -> Optional[Recorder]:
    """Swap the process recorder (tests; child processes inherit the
    run id via env instead).  Returns the previous one."""
    global _RECORDER
    with _RECORDER_LOCK:
        old, _RECORDER = _RECORDER, rec
        return old


def span(name: str, **attrs) -> Span:
    return recorder().span(name, **attrs)


def point(name: str, **attrs) -> None:
    recorder().point(name, **attrs)


def run_id() -> str:
    return recorder().run_id
