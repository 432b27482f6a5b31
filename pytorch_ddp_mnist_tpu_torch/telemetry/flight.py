"""Flight recorder: a bounded ring buffer of recent serve events, flushed
to disk on failure so a dead server leaves a structured post-mortem
instead of a log tail (the port's copy of
`pytorch_ddp_mnist_tpu/telemetry/flight.py`; its dumps have the same v2
schema).

  * `record(kind, **fields)` appends one timestamped entry to a
    fixed-capacity deque — constant memory at any rate, the oldest entries
    drop first (with an exact `dropped` count), and nothing touches disk
    on the happy path;
  * producers are the paths that only matter when things go wrong:
    `serve/admission.py`'s reject path (incl. the predicted-p99 SLO
    boundary, with the predicted value that fired) and
    `serve/tracing.py`'s drain-time slowest-request exemplars;
  * `dump(reason)` flushes the ring as one JSON file — into the configured
    dump dir (`set_dump_dir`, wired to `serve --telemetry DIR`), else
    `$PDMT_FLIGHT_DIR`, else the system temp dir — and returns the path;
  * `install_sigterm_flush()` chains a dump in front of the existing
    SIGTERM disposition, so a killed run still leaves the post-mortem.

Dumping is deliberately infallible-by-contract: any write failure returns
None rather than raising — the recorder must never turn a primary failure
into a secondary crash. Pure stdlib.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import tempfile
import threading
import time
from typing import List, Optional

DEFAULT_CAPACITY = 256
# v2: every entry carries a `rank` field stamped at RECORD time (merged
# multi-rank dumps are attributable; previously only some wireup entries
# carried process identity). Backward-compatible: v1 dumps stay readable,
# and the checker (scripts/check_telemetry.py) only enforces the rank
# field on v2 payloads.
_SCHEMA = 2


def _env_rank() -> int:
    """Default rank: the launcher's $RANK (the env wireup chain's
    spelling), else 0; `set_rank` rebinds it."""
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


class FlightRecorder:
    """The ring. One per process (module-level singleton below); thread-safe
    — probe threads, the asyncio serve loop, and signal handlers all
    record."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._entries: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        # RLock, not Lock: a SIGTERM handler dumps the ring from the main
        # thread, and the signal can land while that same thread is inside
        # record()'s critical section — a non-reentrant lock would deadlock
        # the dying process instead of writing its post-mortem.
        self._lock = threading.RLock()
        self._recorded = 0  # total ever recorded (dropped = this - len)
        self.dump_dir: Optional[str] = None
        self.rank = _env_rank()

    def record(self, kind: str, **fields) -> None:
        entry = {"t_wall": time.time(), "t_mono": time.perf_counter(),
                 "kind": str(kind)}
        entry.update(fields)
        # rank stamped at record time (a producer that knows better — the
        # fault injector's rank-gated specs — passes its own and wins)
        if "rank" not in entry:
            entry["rank"] = self.rank
        with self._lock:
            entry["seq"] = self._recorded
            self._recorded += 1
            self._entries.append(entry)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    @property
    def recorded(self) -> int:
        return self._recorded

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._recorded - len(self._entries)

    def _resolve_dir(self) -> str:
        return (self.dump_dir or os.environ.get("PDMT_FLIGHT_DIR")
                or tempfile.gettempdir())

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Flush the ring to `path` (default: `flight.<pid>.json` under the
        resolved dump dir) and return the written path; None when nothing
        was ever recorded or the write fails (a post-mortem writer must
        never crash the path that is already failing). Atomic via
        write-then-replace: a reader (one following the
        artifact stamp) never sees a torn file."""
        entries = self.snapshot()
        if not entries:
            return None
        payload = {
            "v": _SCHEMA,
            "reason": str(reason),
            "pid": os.getpid(),
            "rank": self.rank,
            "dumped_t_wall": time.time(),
            "recorded": self._recorded,
            "dropped": self._recorded - len(entries),
            "entries": entries,
        }
        try:
            if path is None:
                out_dir = self._resolve_dir()
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"flight.{os.getpid()}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except OSError:
            return None


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **fields) -> None:
    """Append one entry to the process-wide ring (constant cost, no I/O)."""
    _RECORDER.record(kind, **fields)


def set_dump_dir(path: Optional[str]) -> None:
    """Route dumps next to the JSONL trace (`serve --telemetry DIR` wires
    DIR here, so the post-mortem lands with the run's other evidence)."""
    _RECORDER.dump_dir = path


def set_rank(rank: int) -> None:
    """Late rank binding: every later entry is stamped with `rank`
    (earlier entries carry the $RANK-seeded default)."""
    _RECORDER.rank = int(rank)


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    return _RECORDER.dump(reason, path)


_sigterm_installed = False
# signal.signal only works from the main thread, but nothing stops two
# threads RACING the installed-flag check (each would chain the other's
# handler — the "never a loop" promise breaks); the lock makes the
# check-then-install atomic.
_SIGTERM_LOCK = threading.Lock()


def install_sigterm_flush() -> bool:
    """Chain a flight dump in front of the current SIGTERM disposition.
    Returns False (and installs nothing) off the main thread or where
    signals are unsupported; repeat installs are no-ops (one chain link,
    never a loop)."""
    global _sigterm_installed
    with _SIGTERM_LOCK:
        if _sigterm_installed:
            return True

        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _flush_and_chain(signum, frame):
                _RECORDER.dump(reason="SIGTERM")
                if callable(prev):
                    prev(signum, frame)
                elif prev is signal.SIG_IGN:
                    # the run was launched ignoring SIGTERM (supervisor
                    # choice): preserve that — dump, keep living
                    return
                else:
                    # SIG_DFL (or an unknowable non-Python handler, prev is
                    # None): restore the default disposition and re-deliver,
                    # so the process still dies by SIGTERM (exit status
                    # intact)
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, _flush_and_chain)
        except (ValueError, OSError):  # non-main thread / unsupported
            return False               # platform
        _sigterm_installed = True
        return True
