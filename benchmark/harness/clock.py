"""Frame-end marks on the device's clock (CUDA events, read after the
window with one synchronize) or, on a CPU rehearsal, the host's."""
from __future__ import annotations

import time

import torch


class FrameClock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._start = None
        self._ends: list = []

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        self._ends = []

    def mark(self) -> None:
        """The end of a frame: recorded behind the frame's work."""
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._ends.append(e)
        else:
            self._ends.append(time.perf_counter())

    def ends_ms(self) -> list[float]:
        """Each frame's end, in ms from the start (synchronizes once)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            return [self._start.elapsed_time(e) for e in self._ends]
        return [(t - self._start) * 1e3 for t in self._ends]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
