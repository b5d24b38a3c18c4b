"""Engine settings files — the part of ``vqengine_tpu/engine/settings.py``
the port needs so far: the environment-map presets of
Data/EnvironmentMaps.ini. (The engine and graphics settings, scene mapping
and HDR display profiles come with the engine shell.)"""
from __future__ import annotations

from pathlib import Path

from ..utils.ini import parse_ini


def load_environment_map_presets(data_dir: str | Path) -> dict[str, dict[str, str]]:
    """Parse EnvironmentMaps.ini presets: name -> {Path, MaxCLL}."""
    p = Path(data_dir) / "EnvironmentMaps.ini"
    if not p.is_file():
        return {}
    return {k: dict(v) for k, v in parse_ini(p).items() if k}
