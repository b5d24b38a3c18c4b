"""Minimal INI parser matching the reference's FileParser INI handling
(Source/Engine/Core/FileParser.cpp: ParseEngineSettingsFile, Scenes.ini,
EnvironmentMaps.ini, HDRDisplayProfiles.ini).

The reference files use ``[Section]`` headers, ``Key=Value`` pairs and ``;``
comments; sections may butt up against each other without blank lines.
"""
from __future__ import annotations

from pathlib import Path


def parse_ini(path: str | Path) -> dict[str, dict[str, str]]:
    sections: dict[str, dict[str, str]] = {}
    current: dict[str, str] | None = None
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith(";") or line.startswith("#"):
            continue
        # a line can contain "]Key=Value"-free but "[Sec]" may be glued to
        # a previous value in hand-edited files; handle plain forms only.
        if line.startswith("["):
            end = line.find("]")
            if end > 0:
                name = line[1:end].strip()
                current = sections.setdefault(name, {})
                rest = line[end + 1:].strip()
                if rest and "=" in rest:  # tolerate "[Sec]Key=Value"
                    k, v = rest.split("=", 1)
                    current[k.strip()] = v.strip()
                continue
        if "=" in line:
            if current is None:
                current = sections.setdefault("", {})
            k, v = line.split("=", 1)
            current[k.strip()] = v.strip()
    return sections


def parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")
