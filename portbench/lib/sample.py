"""A seeded uniform sample of the answers a window produced."""
from __future__ import annotations

import random
from typing import Callable, List


class Reservoir:
    """Keeps ``k`` of the items offered, each offered item equally likely
    (reservoir sampling), drawing from ``rng``; ``make`` builds an item only
    where it is kept, so offering costs nothing on the timed path."""

    def __init__(self, k: int, rng: random.Random):
        self.k = k
        self.rng = rng
        self.seen = 0
        self.items: List = []

    def offer(self, make: Callable) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()
