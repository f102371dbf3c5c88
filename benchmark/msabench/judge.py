"""Whether the window's answers are right: the comparison that decides ``correct``.

A job's answer is its chain hash and penalty list, and with
``keep_alignments`` each pair's penalty and aligned strings. The window
keeps the whole answers of a sample of its jobs drawn from the seed (one in
each block of the traffic's ``keep_every``, and the last). After the window
has closed:

- ``jobs_failed``: jobs that raised instead of answering;
- ``folds_wrong``: kept jobs whose answer is not the fold of their own
  pairs: the penalty list is not the pairs' penalties in task order, or the
  chain hash is not the reference's SHA-512 chain of the pairs' strings;
- ``penalties_wrong`` and ``alignments_wrong``: of a sample of pairs drawn
  from the seed among the kept jobs (``check_pairs`` of the configuration;
  the first two are the largest and the smallest pair of drawn jobs), those
  whose penalty, or whose two strings, differ from the plain reference's
  (``reference/nw.py``), run once on the same sequences.

Each is an exact comparison, so each limit is 0 (``LIMITS``). A sampled
pair covers the fill (its penalty), the walk and the decode (its strings,
which the traceback's tie-break fixes); the fold covers the host's hashing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from msabench import generate
from reference import hashing, nw, tasks

LIMITS = {"jobs_failed": 0, "folds_wrong": 0, "penalties_wrong": 0, "alignments_wrong": 0}


def fold_ok(result, problem: generate.Problem) -> bool:
    pairs = result.pair_results
    expect = len(tasks.pairs(len(problem.genes)))
    if pairs is None or len(pairs) != expect:
        return False
    if [p.task_id for p in pairs] != list(range(expect)):
        return False
    if [int(p.penalty) for p in pairs] != [int(v) for v in result.penalties]:
        return False
    return result.chain_hash == hashing.chain(hashing.pair_hash(p.align1, p.align2)
                                              for p in pairs)


def draw(seed: int, done: Sequence[int], problem: generate.Problem,
         count: int) -> List[Tuple[int, int]]:
    """``count`` distinct (job, task) of the jobs ``done``, drawn from the seed.

    The first is the largest pair of a drawn job and the second its smallest
    (by m + n, then m x n), so that both ends of any schedule that orders
    pairs by size are checked in every run: a batch that fills the largest
    pairs first puts the smallest in its last wave. The rest are uniform."""
    rng = generate.sample_rng(seed)
    sizes = [len(g) for g in problem.genes]
    order = tasks.pairs(len(sizes))

    def size(t: int) -> Tuple[int, int]:
        i, j = order[t]
        return sizes[i] + sizes[j], sizes[i] * sizes[j]

    ends = [max(range(len(order)), key=size), min(range(len(order)), key=size)]
    count = min(count, len(done) * len(order))
    picks: List[Tuple[int, int]] = []
    while len(picks) < count:
        task = ends[len(picks)] if len(picks) < len(ends) else int(rng.integers(len(order)))
        pick = (int(done[rng.integers(len(done))]), task)
        if pick not in picks:
            picks.append(pick)
    return picks


def sampled_pairs(picks, job_problem, pool) -> List[Tuple[str, str]]:
    """(x, y) of each pick: x the rows (sequence i of the task), y the columns."""
    out = []
    for job, task in picks:
        genes = pool[job_problem[job]].genes
        i, j = tasks.pairs(len(genes))[task]
        out.append((genes[i], genes[j]))
    return out


def compare(answers: Sequence, expected: Sequence) -> Tuple[int, int]:
    """(penalties wrong, alignments wrong) of (penalty, align1, align2) answers;
    None stands for an answer that never came."""
    pen = ali = 0
    for got, want in zip(answers, expected):
        if got is None:
            pen, ali = pen + 1, ali + 1
            continue
        pen += int(got[0]) != want[0]
        ali += (got[1], got[2]) != (want[1], want[2])
    return pen, ali


def judge(jobs: List, pool: List[generate.Problem], config: Dict, seed: int,
          device: torch.device) -> Tuple[bool, Dict[str, int], Dict[str, int]]:
    """(correct, the numbers compared, what was checked)."""
    failed = sum(job.error is not None for job in jobs)
    done = [n for n, job in enumerate(jobs) if job.error is None and job.result is not None]
    folds_wrong = sum(not fold_ok(jobs[n].result, pool[jobs[n].problem]) for n in done)
    pen = ali = 0
    picks = []
    if done:
        picks = draw(seed, done, pool[0], config["check_pairs"])
        answers = []
        for job, task in picks:
            pairs = jobs[job].result.pair_results
            p = pairs[task] if pairs is not None and task < len(pairs) else None
            answers.append(None if p is None else (p.penalty, p.align1, p.align2))
        expected = nw.align(sampled_pairs(picks, [j.problem for j in jobs], pool),
                            config["pxy"], config["pgap"], device)
        pen, ali = compare(answers, expected)
    compared = {"jobs_failed": failed, "folds_wrong": folds_wrong, "penalties_wrong": pen,
                "alignments_wrong": ali}
    correct = bool(done) and all(compared[k] <= LIMITS[k] for k in LIMITS)
    answered = sum(job.error is None for job in jobs)
    return correct, compared, {"jobs_answered": answered, "jobs_checked": len(done),
                               "pairs_checked": len(picks)}
