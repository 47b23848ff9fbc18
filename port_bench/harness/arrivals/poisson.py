"""Open loop: ``rate_per_s`` (the cell's) x seconds requests, due at the
times of a Poisson process over the window, each sent on its due time
whatever the server has answered."""

import time

from harness import seeded


def plan(traffic: dict, params: dict, seconds: float, rng):
    n = max(int(round(params["rate_per_s"] * seconds)), 1)
    return n, seeded.poisson_dues(n, seconds, rng)


def drive(traffic: dict, n: int, due, submit, freed, t0: float, seconds: float) -> None:
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        submit(i)
