"""Command-line contract — mirrors reference ParseCommandLineParameters
(Source/Engine/Main.cpp:38-174): -Test, -TestFrames=N, -W/-Width, -H/-Height,
-Windowed, -Fullscreen, -VSync[=b], -AntiAliasing/-AA, -TripleBuffering,
-DoubleBuffering, -HDR[=b], -MaxFrameRate=N|Auto, -Scene=name,
-LogConsole, -LogFile[=path].
"""
from __future__ import annotations

from .settings import FStartupParameters


def _split(arg: str) -> tuple[str, str | None]:
    if "=" in arg:
        k, v = arg.split("=", 1)
        return k, v
    return arg, None


def _to_bool(v: str | None, default: bool = True) -> bool:
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def parse_command_line(argv: list[str]) -> FStartupParameters:
    p = FStartupParameters()
    for arg in argv:
        if not arg.startswith("-"):
            continue
        name, val = _split(arg)
        lname = name.lower()
        if lname == "-logconsole":
            p.set("bLogConsole", True)
        elif lname == "-logfile":
            p.set("bLogFile", True)
            if val:
                p.set("LogFilePath", val)
        elif lname == "-test":
            p.set("bAutomatedTestRun", True)
        elif lname == "-testframes":
            p.set("bAutomatedTestRun", True)
            if val:
                p.set("NumAutomatedTestFrames", int(val))
        elif lname in ("-width", "-w"):
            if val:
                p.set("Width", int(val))
        elif lname in ("-height", "-h"):
            if val:
                p.set("Height", int(val))
        elif lname == "-windowed":
            p.set("DisplayMode", "Windowed")
        elif lname == "-fullscreen":
            p.set("DisplayMode", "BorderlessFullscreen")
        elif lname == "-vsync":
            p.set("bVsync", _to_bool(val))
        elif lname in ("-antialiasing", "-aa"):
            p.set("bAntiAliasing", _to_bool(val))
        elif lname == "-triplebuffering":
            p.set("bUseTripleBuffering", True)
        elif lname == "-doublebuffering":
            p.set("bUseTripleBuffering", False)
        elif lname == "-hdr":
            p.set("bHDR", _to_bool(val))
        elif lname in ("-maxframerate", "-maxfps"):
            if val in ("Auto", "Automatic", "-1"):
                p.set("MaxFrameRate", -1)
            elif val is not None:
                p.set("MaxFrameRate", int(val))
        elif lname == "-scene":
            if val:
                p.set("SceneName", val)
        elif lname in ("-outputdir", "-out"):
            if val:
                p.set("OutputDir", val)
        # unknown flags ignored, like the reference
    return p
