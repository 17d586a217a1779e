"""Seeded EM task sets shaped like the main path's phase D, for holding
the EM kernel against its plain version (tests and ``chip_smoke.py``).

Each task is a noise-normalised matrix (R, C) whose last column is the
noise probability, with integral read counts (R,), as phase C emits
them.  Sizes follow the main path's distribution at bench scale (rows:
median 3, at most 348; columns: median 9, at most 61).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Task = Tuple[np.ndarray, np.ndarray]

MAX_ROWS = 348
MAX_COLS = 61


def random_task(rng: np.random.Generator, R: int, C: int) -> Task:
    probs = np.zeros((R, C), dtype=np.float64)
    for r in range(R):
        noise = rng.uniform(1e-4, 0.05)
        probs[r, -1] = noise
        if C > 1:
            k = 1 + rng.binomial(C - 2, 0.3) if C > 2 else 1
            cols = rng.choice(C - 1, size=k, replace=False)
            weights = rng.exponential(1.0, size=k)
            probs[r, cols] = (1.0 - noise) * weights / weights.sum()
    counts = rng.geometric(0.3, size=R).astype(np.float64)
    return probs, counts


def edge_case_tasks(rng: np.random.Generator) -> List[Task]:
    """R = 1; C = 1 (noise only); a task with an all-zero row and a
    zero-count row.  (Tasks that hit max_em_its come from running the
    random set with a small iteration cap.)"""
    tasks = [random_task(rng, 1, 5)]
    noise_only = rng.uniform(0.01, 1.0, size=(4, 1))
    tasks.append((noise_only, np.array([1.0, 3.0, 2.0, 5.0])))
    probs, counts = random_task(rng, 6, 4)
    probs[2] = 0.0
    counts[4] = 0.0
    tasks.append((probs, counts))
    return tasks


def em_task_set(n_tasks: int, seed: int) -> List[Task]:
    """``n_tasks`` random tasks (one of them at the largest main-path
    size) followed by :func:`edge_case_tasks`."""
    rng = np.random.default_rng(seed)
    tasks = [random_task(rng, MAX_ROWS, MAX_COLS)] if n_tasks else []
    while len(tasks) < n_tasks:
        R = int(np.clip(round(np.exp(rng.normal(np.log(3.0), 1.1))), 1, MAX_ROWS))
        C = int(np.clip(round(np.exp(rng.normal(np.log(9.0), 0.6))), 2, MAX_COLS))
        tasks.append(random_task(rng, R, C))
    return tasks + edge_case_tasks(rng)
