"""Synchronizations of the host with the card a frame: the program's
counter of blocking reads and pageable uploads, all sites (trace.blocking)."""
from harness import spans


def read(ctx):
    s = spans.syncs()
    return None if s is None else s[0]
