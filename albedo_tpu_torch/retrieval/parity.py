"""Candidate-set parity between the bank and the host-side score paths.

Port of ``albedo_tpu/retrieval/parity.py`` (numpy only, unchanged).

The acceptance contract for the bank (tests AND the bench's parity gate):
for each registered source, the bank-served top-k over the probe users must
match the existing host-side recommender's top-k — scores within ``atol``,
item sets equal **modulo tie handling** (two items whose scores differ by
less than ``atol`` are interchangeable at the cut; both paths sort
value-desc with index-asc tie-break, but their index SPACES differ, so the
tie ORDER can legitimately differ while the score profile cannot).
"""

from __future__ import annotations

import numpy as np


def candidate_parity(
    host: "tuple[np.ndarray, np.ndarray]",
    bank: "tuple[np.ndarray, np.ndarray]",
    atol: float = 1e-5,
) -> dict:
    """Compare one user's host vs bank top-k: ``(item_ids, scores)`` pairs,
    score-descending. Returns a report dict with ``ok`` plus what broke."""
    h_ids, h_scores = (np.asarray(a) for a in host)
    b_ids, b_scores = (np.asarray(a) for a in bank)
    report: dict = {"ok": True, "n_host": int(h_ids.size), "n_bank": int(b_ids.size)}
    if h_ids.size != b_ids.size:
        report.update(ok=False, why="candidate count differs")
        return report
    if h_ids.size == 0:
        return report
    order_h = np.argsort(-h_scores, kind="stable")
    order_b = np.argsort(-b_scores, kind="stable")
    hs, bs = h_scores[order_h], b_scores[order_b]
    score_err = float(np.max(np.abs(hs - bs)))
    report["max_score_err"] = score_err
    if score_err > atol:
        report.update(ok=False, why=f"rank-wise scores differ by {score_err:.2e}")
        return report
    # Set equality modulo ties: any item in exactly one set must be tied
    # (within atol) with an item of the other set at the same score level.
    only_h = np.setdiff1d(h_ids, b_ids)
    only_b = np.setdiff1d(b_ids, h_ids)
    report["symmetric_difference"] = int(only_h.size + only_b.size)
    for ids, own_ids, own_scores, other_scores in (
        (only_h, h_ids, h_scores, b_scores),
        (only_b, b_ids, b_scores, h_scores),
    ):
        for item in ids:
            s = float(own_scores[np.nonzero(own_ids == item)[0][0]])
            if not np.any(np.abs(other_scores - s) <= atol):
                report.update(
                    ok=False,
                    why=(
                        f"item {int(item)} (score {s:.6g}) has no tied "
                        f"counterpart in the other path's set"
                    ),
                )
                return report
    return report


def frame_to_pairs(frame, user_id: int) -> tuple[np.ndarray, np.ndarray]:
    """A recommender frame's rows for one user as ``(item_ids, scores)``."""
    rows = frame[frame["user_id"] == int(user_id)]
    return (
        rows["repo_id"].to_numpy(np.int64),
        rows["score"].to_numpy(np.float64),
    )
