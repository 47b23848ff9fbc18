"""Closed loop: ``clients`` (the mix's) clients, each sending its next
request the moment its last one is answered, until the window closes. With
three times ``max_batch`` clients every batch the server forms is full, so
the answered rate is the server's capacity, which no offered rate caps.
The schedule holds ``ceiling_per_s`` x seconds requests more than the
clients; a run that uses them all fails rather than report a capped rate."""

import queue
import time


def plan(traffic: dict, params: dict, seconds: float, rng):
    return traffic["clients"] + int(traffic["ceiling_per_s"] * seconds), None


def drive(traffic: dict, n: int, due, submit, freed, t0: float, seconds: float) -> None:
    end = t0 + seconds
    wait = t0 - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    for i in range(traffic["clients"]):
        submit(i)
    nxt = traffic["clients"]
    while True:
        left = end - time.perf_counter()
        if left <= 0:
            return
        try:
            freed.get(timeout=left)
        except queue.Empty:
            return
        if time.perf_counter() >= end:
            return
        if nxt >= n:
            raise RuntimeError("the closed loop sent every request of its schedule before the "
                               "window closed: raise the mix's ceiling_per_s")
        submit(nxt)
        nxt += 1
