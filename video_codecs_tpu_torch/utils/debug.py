"""Runtime debug/env-flag registry.

The port's copy of video_codecs_tpu/utils/debug.py, whole; each function
keeps its name and a comment gives the original's line.  Parity:
hm-16.5rc1 TLibCommon/Debug.h:64-108 — HM registers `EnvVar` objects
(name, default, help) read from the process environment, plus a
`DebugOptionList` of encoder-forcing switches (DebugSBAC, ForceLumaMode,
…).  Here: the same registry pattern with a `VCT_` prefix; modules call
`env_flag`/`env_int`/`env_str` to declare their switches (the host
quadtree encoder's VCT_DUMP_MODES), and `print_env_vars()` mirrors HM's
env-var help dump.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


# video_codecs_tpu/utils/debug.py:17
@dataclass
class EnvVar:
    name: str
    default: str
    help: str

    # video_codecs_tpu/utils/debug.py:23
    @property
    def value(self) -> str:
        return os.environ.get(self.name, self.default)


_REGISTRY: dict[str, EnvVar] = {}


# video_codecs_tpu/utils/debug.py:31
def register(name: str, default: str, help_text: str) -> EnvVar:
    if name not in _REGISTRY:
        _REGISTRY[name] = EnvVar(name, default, help_text)
    return _REGISTRY[name]


# video_codecs_tpu/utils/debug.py:37
def env_str(name: str, default: str, help_text: str) -> str:
    return register(name, default, help_text).value


# video_codecs_tpu/utils/debug.py:41
def env_int(name: str, default: int, help_text: str) -> int:
    return int(register(name, str(default), help_text).value)


# video_codecs_tpu/utils/debug.py:45
def env_flag(name: str, default: bool, help_text: str) -> bool:
    v = register(name, "1" if default else "0", help_text).value
    return v.strip().lower() not in ("", "0", "false", "no", "off")


# video_codecs_tpu/utils/debug.py:50
def registered() -> list[EnvVar]:
    return sorted(_REGISTRY.values(), key=lambda e: e.name)


# video_codecs_tpu/utils/debug.py:54
def print_env_vars() -> str:
    """HM-style env-var listing (Debug.cpp printEnvVarInUse analog)."""
    lines = ["Environment variables:"]
    for e in registered():
        cur = e.value
        mark = "*" if cur != e.default else " "
        lines.append(f" {mark}{e.name} = {cur} (default {e.default}) "
                     f"- {e.help}")
    return "\n".join(lines)


# the debug switches the framework itself consults (DebugOptionList analog)
TRACE = register("VCT_TRACE", "0",
                 "syntax-element trace: 1 = collect encoder/decoder "
                 "syntax traces (ENC_DEC_TRACE analog)")
FORCE_I4 = register("VCT_FORCE_I4", "0",
                    "H.264: force I_4x4 for every intra MB "
                    "(ForceIntraMode analog)")
DUMP_MODES = register("VCT_DUMP_MODES", "0",
                      "print per-CU/MB mode decisions after each frame "
                      "(hm-12.1-statistic-for-modes encodeCU2 analog)")
