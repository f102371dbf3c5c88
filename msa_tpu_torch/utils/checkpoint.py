"""Checkpoint / resume for the k-way engine.

The reference had no recovery story at all: a Slurm time-limit kill or an
ORTE "lost communication" abort threw the whole run away (SURVEY.md §5;
preserved failures in ``testing/12node-16-cpt-1-npn-physical.txt``). Here
every completed pair result — (task_id, penalty, pair hash) — is appended to
a JSONL journal as it finishes, and a restarted run replays the journal and
computes only the missing pairs. The final chain hash folds identically
because results are keyed by task id, never by completion order
(the same property that made the reference's output sharding-independent,
``submit/xuliny-seqalkway.cpp:314,334-337``).

The journal is per-process in multi-host runs (each process owns its shard
of the pair list, so journals never conflict); pass a path template with
``{proc}`` to keep them separate.

The port's own copy of ``msa_tpu/utils/checkpoint.py``; the port imports nothing of the JAX
package. The tests hold the two copies equal.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple


class PairJournal:
    """Append-only JSONL journal of completed pair results."""

    def __init__(self, path: str, problem_key: str):
        self.path = path
        self.problem_key = problem_key
        self._fh = None

    def load(self) -> Dict[int, Tuple[int, str]]:
        """Replay the journal; returns {task_id: (penalty, hash)}.

        Records from a different problem (key mismatch) are ignored — a
        stale journal can never corrupt a new run's output. Truncated final
        lines (crash mid-write) are skipped.
        """
        done: Dict[int, Tuple[int, str]] = {}
        if not os.path.exists(self.path):
            return done
        with open(self.path, "r", encoding="ascii") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write
                if rec.get("problem") != self.problem_key:
                    continue
                if not isinstance(rec.get("hash"), str) or len(rec["hash"]) != 128:
                    continue
                done[int(rec["task_id"])] = (int(rec["penalty"]), rec["hash"])
        return done

    def record(self, task_id: int, penalty: int, pair_hash: str) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="ascii")
        self._fh.write(
            json.dumps(
                {
                    "problem": self.problem_key,
                    "task_id": task_id,
                    "penalty": penalty,
                    "hash": pair_hash,
                }
            )
            + "\n"
        )
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "PairJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def problem_key(pxy: int, pgap: int, genes) -> str:
    """Stable identity of a problem instance for journal validation.

    Hash of the parameters and all sequences — cheap relative to one pair
    DP, and guarantees resume only ever applies to the identical input.
    """
    import hashlib

    h = hashlib.sha256()
    h.update(f"{pxy} {pgap} {len(genes)}".encode())
    for g in genes:
        h.update(b"\x00")
        h.update(g.encode("latin-1"))
    return h.hexdigest()
