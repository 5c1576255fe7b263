"""The one generator of requests: a closed loop over a pool of right-hand
sides, read from a traffic file (``benchmark/traffic/<name>.json``).

Keys it reads:

* ``pool``: how many right-hand sides the benchmark makes (each request
  solves one of them; every pool entry comes once in each round, in an
  order drawn from the seed);
* ``rhs_columns``: 1 for a vector b, k for an (n, k) block;
* ``base_seed`` (optional): the pool's x_j come from this fixed seed and
  the run's seed draws each entry's sign and power-of-two scale
  (``core.stencil.rhs_pool``), so every seed sends the same iterations;
* ``refresh_every``: 0, or m to replace the matrix values every m-th
  request by the base values times a scale drawn from the seed in [1, 2)
  (a new values tensor, as a time-stepper hands the solver);
* ``warmup_solves``, ``trace_solves``, ``check_solves``: requests solved in
  set-up, in a traced run, and kept for the reference's check.

Every seed gets the same sizes and the same number of refreshes; only
the draws and their order change.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class Request:
    pool_index: int
    scale: Optional[float]   # a new matrix scale, or None to keep the last


def requests(seed: int, traffic: dict) -> Iterator[Request]:
    """Endless closed-loop requests for ``seed``."""
    rng = random.Random(int(seed) * 7919 + 1)
    pool = int(traffic["pool"])
    every = int(traffic.get("refresh_every", 0))
    order: list = []
    i = 0
    while True:
        if not order:
            order = list(range(pool))
            rng.shuffle(order)
        scale = (1.0 + rng.random()) if every and i and i % every == 0 \
            else None
        yield Request(order.pop(), scale)
        i += 1


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from the seed (algorithm R): the solves the reference checks."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(int(seed) * 104729 + 3)
        self.size = int(size)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1
