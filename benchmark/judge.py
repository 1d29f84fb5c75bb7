"""The comparison that decides ``correct``.

A run's answers are judged once the window has closed and the program's
state is freed.  Each compared number has a limit in the cell's file,
``workloads/<cell>.json``; ``PERF.md`` gives the readings each limit was set
from.

* ``dist_gap``: over every id the program returned, the gap between the
  distance it returned and the plain reference's distance of that query to
  that row, as a share of the reference's k-th nearest distance for the
  query.  Rounding in float32 reads about 1e-6; a product in TF32 (the
  control), an id swapped for another, or an answer handed to the wrong
  query reads orders of magnitude more.
* ``bad_rows``: answer rows with an id outside the corpus or repeated, or
  with a distance that is not finite or not ascending.  Exact: limit 0.
* ``unanswered``: queries sent whose answer never came, or came short of
  rows or of k columns.  Exact: limit 0.
* ``missing_rows`` (builds): corpus rows absent from the bottom layer of the
  built index.  Exact: limit 0.

``failed_calls`` counts the calls with a bad row or an unanswered query: the
result's ``failed``.

``recall_at_10`` is read here too, against the reference's exact top-k over
every query answered, but it is an end-to-end metric held by its bound, not
a limit: the control reads it at 0.998, so it has no upper reading.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchmark import reference


@dataclass
class Answer:
    """One distinct answer to the queries ``[offset, offset + due)``:
    ``ids`` and ``dists`` as the program returned them, on the host, and how
    many calls gave exactly this answer."""

    offset: int
    due: int
    ids: torch.Tensor
    dists: torch.Tensor
    count: int = 1


class AnswerLog:
    """Every answer of a window, each distinct one kept once.  An answer
    equal to the last one kept for the same queries only raises its count,
    so a window of thousands of identical batches keeps one."""

    def __init__(self) -> None:
        self.answers: List[Answer] = []
        self._last: Dict[int, Answer] = {}
        self.due: Dict[int, List[int]] = {}  # offset -> [queries, calls]

    def expect(self, offset: int, due: int) -> None:
        """A call for the queries ``[offset, offset + due)`` was sent."""
        self.due.setdefault(offset, [due, 0])[1] += 1

    def add(self, offset: int, due: int, ids: torch.Tensor, dists: torch.Tensor) -> None:
        last = self._last.get(offset)
        # numpy compares on the calling thread: torch.equal on the CPU wakes
        # its thread pool, which on a shared host stalls the loop for ms
        if (
            last is not None
            and last.due == due
            and np.array_equal(last.ids.numpy(), ids.numpy())
            and np.array_equal(last.dists.numpy(), dists.numpy())
        ):
            last.count += 1
            return
        answer = Answer(offset, due, ids, dists)
        self.answers.append(answer)
        self._last[offset] = answer

    @property
    def calls(self) -> int:
        return sum(a.count for a in self.answers)


def judge(
    log: AnswerLog,
    corpus: torch.Tensor,
    queries: torch.Tensor,
    ref_ids: torch.Tensor,
    ref_dists: torch.Tensor,
    metric: str,
    k: int,
) -> Dict[str, float]:
    """The compared numbers and ``recall_at_10`` over every answer in ``log``;
    ``ref_ids`` / ``ref_dists`` are the reference's exact top-k of every
    query, on the corpus's device."""
    n = corpus.shape[0]
    dev = corpus.device
    gap = 0.0
    bad = unanswered = failed = 0
    hits = answered = 0
    answered_calls: Dict[int, int] = {}
    for a in log.answers:
        answered_calls[a.offset] = answered_calls.get(a.offset, 0) + a.count
    for offset, (due, calls) in log.due.items():
        missing = calls - answered_calls.get(offset, 0)
        unanswered += due * missing
        failed += missing
    for a in log.answers:
        q = queries[a.offset : a.offset + a.due]
        ids = a.ids.to(dev).long()
        dists = a.dists.to(dev).float()
        if ids.ndim != 2 or ids.shape[0] != a.due or ids.shape[1] < k or dists.shape != ids.shape:
            unanswered += a.due * a.count
            failed += a.count
            continue
        ids, dists = ids[:, :k], dists[:, :k]
        inside = (ids >= 0) & (ids < n)
        srt = torch.sort(ids, dim=1).values
        repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
        finite = torch.isfinite(dists).all(1)
        ascending = (dists[:, 1:] >= dists[:, :-1]).all(1)
        ok = inside.all(1) & ~repeated & finite & ascending
        n_bad = int((~ok).sum())
        bad += n_bad * a.count
        failed += a.count if n_bad else 0
        if bool(ok.any()):
            qo, io, do = q[ok], ids[ok], dists[ok]
            want = reference.pair_distances(corpus, qo, io, metric)
            scale = ref_dists[a.offset : a.offset + a.due][ok][:, k - 1 : k].clamp_min(1e-30)
            gap = max(gap, float(((do - want).abs() / scale).max()))
        r = ref_ids[a.offset : a.offset + a.due, :k]
        hits += int((ids[:, :, None] == r[:, None, :]).any(-1).sum()) * a.count
        answered += a.due * a.count
    return {
        "dist_gap": gap,
        "bad_rows": float(bad),
        "unanswered": float(unanswered),
        "failed_calls": float(failed),
        "recall_at_10": hits / (answered * k) if answered else 0.0,
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in the order of ``limits``."""
    return {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
