"""Crash-witness journal: which configuration was in flight when the
process died (port of ``engine/journal.py``, the same JSONL format).

Before the first dispatch of a configuration the trainer has not run in
this process (a new graph key, a new refine capacity, a new eval K), it
appends an ``attempt`` record; once that dispatch has completed
(``torch.cuda.synchronize()``), a matching ``ok``. On CUDA an out-of-memory
error is an exception, but some errors leave the context unusable for the
rest of the process (an illegal address, a launch failure, a device-side
assert, an Xid): the process must restart, and then the unmatched attempt
is the evidence. On restart (``Trainer._apply_crash_policy``, and the
``cli train --supervise`` loop) the crashed configuration is refused by
that evidence: a crashed capacity growth is not attempted again, a crashed
K caps that resolution bucket's K below the killing value, a crashed eval
caps the eval K. Each record is fsync'd, and a torn last line (a kill
mid-append) is skipped.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List


def _key_of(rec: Dict) -> tuple:
    return tuple(sorted((k, v) for k, v in rec.items() if k != "event"))


class AttemptJournal:
    """Append-only JSONL of (attempt, ok) pairs, fsync'd per record."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def _append(self, rec: Dict) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())  # must survive the process dying now

    def attempt(self, **key) -> None:
        self._append({"event": "attempt", **key})

    def ok(self, **key) -> None:
        self._append({"event": "ok", **key})

    def records(self) -> List[Dict]:
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail write from a kill mid-append
        return out

    def crashed(self) -> List[Dict]:
        """One unmatched attempt per crashed configuration. They are never
        cleared: the crash policy reads them again on every start and
        decides by their count (:meth:`crashed_with_counts`)."""
        return [rec for rec, _ in self.crashed_with_counts()]

    def crashed_with_counts(self) -> List[tuple]:
        """``[(record, attempts - oks)]`` per configuration with a positive
        count: attempted, completed, attempted again and died counts one
        crash; the same configuration dying twice counts two."""
        counts: Dict[tuple, int] = {}
        last: Dict[tuple, Dict] = {}
        for rec in self.records():
            k = _key_of(rec)
            if rec.get("event") == "attempt":
                counts[k] = counts.get(k, 0) + 1
                last[k] = rec
            elif rec.get("event") == "ok":
                counts[k] = counts.get(k, 0) - 1
        return [(last[k], c) for k, c in counts.items() if c > 0]
