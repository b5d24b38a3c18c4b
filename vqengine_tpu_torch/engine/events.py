"""Event system — counterpart of reference Source/Engine/Core/Events.h
(:39-214 event types) and the double-buffered cross-thread queues
(VQEngine.h:269-271, BufferedContainer swap/consume pattern,
VQEngine_EventHandlers.cpp:41-42).

Headless adaptation: window events become framebuffer-size changes; the
swapchain format toggle becomes the HDR output-curve toggle.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class Event:
    pass


@dataclass
class WindowResizeEvent(Event):
    width: int = 0
    height: int = 0


@dataclass
class ToggleFullscreenEvent(Event):
    pass


@dataclass
class SetVSyncEvent(Event):
    enabled: bool = True


@dataclass
class SetHDREvent(Event):
    """Swapchain format / color-space change (SwapChain.h:76-99)."""
    enabled: bool = True


@dataclass
class SetEnvironmentMapEvent(Event):
    preset: str = ""


@dataclass
class KeyDownEvent(Event):
    key: str = ""


@dataclass
class KeyUpEvent(Event):
    key: str = ""


@dataclass
class MouseMoveEvent(Event):
    dx: float = 0.0
    dy: float = 0.0


@dataclass
class MouseClickEvent(Event):
    x: int = 0
    y: int = 0
    button: int = 0


class BufferedEventQueue:
    """Double-buffered producer/consumer queue (VQUtils BufferedContainer:
    producers fill the front buffer, the consumer swaps and drains the
    back buffer — one lock swap per frame instead of per event)."""

    def __init__(self):
        self._front: list[Event] = []
        self._back: list[Event] = []
        self._lock = threading.Lock()

    def push(self, ev: Event) -> None:
        with self._lock:
            self._front.append(ev)

    def swap_and_drain(self) -> list[Event]:
        with self._lock:
            self._front, self._back = self._back, self._front
        out = self._back
        self._back = []
        return out
