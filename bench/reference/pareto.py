"""Deb's constrained Pareto domination, the plain way (float compares only).

Row ``p`` dominates column ``q`` when p is feasible and q is not, or both
are infeasible and p's violation is smaller, or both are feasible and p is
no worse in every objective and better in one (all minimised).
"""

from __future__ import annotations

import numpy as np
import torch


def domination_block(f_rows, cv_rows, f_cols, cv_cols) -> torch.Tensor:
    """(r, n) bool: row i dominates column j."""
    fa, fb = cv_rows <= 0, cv_cols <= 0
    le = (f_rows[:, None, :] <= f_cols[None, :, :]).all(dim=-1)
    lt = (f_rows[:, None, :] < f_cols[None, :, :]).any(dim=-1)
    both_f = fa[:, None] & fb[None, :]
    both_i = ~fa[:, None] & ~fb[None, :]
    return ((fa[:, None] & ~fb[None, :]) | (both_i & (cv_rows[:, None] < cv_cols[None, :]))
            | (both_f & le & lt))


def _near_dominates(F, V, rows, cols, tol: float):
    """(clear, weak), each (len(rows), len(cols)) bool.  ``clear``: row j
    dominates column i by more than the relative tolerance ``tol`` (Deb's
    rules, with values within ``tol`` of each other taken as equal);
    ``weak``: j is no worse than i beyond ``tol`` in every respect."""
    fj, fi = F[rows][:, None, :], F[cols][None, :, :]
    vj, vi = V[rows][:, None], V[cols][None, :]
    e = tol * torch.maximum(fj.abs(), fi.abs())
    ev = tol * torch.maximum(vj.abs(), vi.abs())
    feas_j, feas_i = vj <= 0, vi <= 0
    both_f, both_i = feas_j & feas_i, ~feas_j & ~feas_i
    no_worse = (fj <= fi + e).all(dim=-1)
    clear = ((feas_j & ~feas_i) | (both_i & (vj < vi - ev))
             | (both_f & no_worse & (fj < fi - e).any(dim=-1)))
    weak = (feas_j & ~feas_i) | (both_i & (vj <= vi + ev)) | (both_f & no_worse)
    return clear, weak


def front_diff(C: np.ndarray, F: np.ndarray, V: np.ndarray, front: set,
               tol: float, device="cpu", rows: int = 1024) -> int:
    """How far the cut vectors ``front`` miss the first front of the
    population ``C`` ((n, k) distinct rows, objectives ``F`` (n, m) to
    minimise, violations ``V``), both read to the relative tolerance
    ``tol``: front members that are not in the population, are
    infeasible while a feasible row exists, or that some row dominates
    clearly; plus rows that nothing dominates clearly and that no front
    member matches or beats within ``tol`` (a front row left out)."""
    Ft = torch.as_tensor(F, dtype=torch.float64, device=device)
    Vt = torch.as_tensor(V, dtype=torch.float64, device=device)
    n = len(C)
    beaten = torch.zeros(n, dtype=torch.bool, device=device)
    everyone = torch.arange(n, device=device)
    for a in range(0, n, rows):
        clear, _ = _near_dominates(Ft, Vt, everyone[a:a + rows], everyone,
                                   tol)
        beaten |= clear.any(dim=0)
    beaten = beaten.cpu().numpy()
    if (V <= 0).any():
        beaten |= V > 0
    index = {tuple(int(v) for v in row): i for i, row in enumerate(C)}
    members = [index.get(tuple(c)) for c in front]
    bad = sum(1 for i in members if i is None or beaten[i])
    members = [i for i in members if i is not None]
    left_out = [i for i in np.flatnonzero(~beaten)
                if tuple(int(v) for v in C[i]) not in front]
    if left_out:
        if members:
            _, weak = _near_dominates(
                Ft, Vt, torch.as_tensor(members, device=device),
                torch.as_tensor(left_out, device=device), tol)
            matched = weak.any(dim=0).cpu().numpy()
        else:
            matched = np.zeros(len(left_out), dtype=bool)
        bad += int((~matched).sum())
    return bad


def packed_bits_mismatch(words, f_rows, cv_rows, f_cols, cv_cols,
                         rows: int = 2048) -> int:
    """Bits of ``words`` ((ceil(r/32), n) int32 carrying uint32 patterns,
    bit j of word w for column q = row 32w+j dominates q) that differ from
    the plain domination of the same inputs; padding rows must be 0."""
    r = f_rows.shape[0]
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bad = 0
    for a in range(0, r, rows):
        w = words[a // 32:(a + rows + 31) // 32].to(torch.int64) & 0xFFFFFFFF
        bits = ((w[:, None, :] >> shifts[None, :, None]) & 1).bool()
        bits = bits.reshape(-1, words.shape[1])
        b = min(a + rows, r)
        want = domination_block(f_rows[a:b], cv_rows[a:b], f_cols, cv_cols)
        bad += int((bits[:b - a] != want).sum())
        bad += int(bits[b - a:].sum())
    return bad
