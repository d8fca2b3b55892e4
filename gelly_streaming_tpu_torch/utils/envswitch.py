"""Shared tri-state config/env switch resolution.

The port's own copy of ``gelly_streaming_tpu/utils/envswitch.py``, whole.
Several data-plane toggles follow the same contract: an int config field in
{-1, 0, 1} where 0/1 force the switch and -1 defers to an env var (or a
string field where "" defers), and an unrecognized env spelling must REFUSE
LOUDLY rather than silently flip the plane the operator meant to switch
(``ops/spmv.resolve_direction``).  One parser here so the spellings — and
the refusal rule — cannot drift apart per switch.
"""

from __future__ import annotations

import os


def env_switch(name: str, default: bool) -> bool:
    """Parse boolean env var ``name``: 0/false/off/no, 1/true/on/yes, unset
    -> ``default``; anything else raises."""
    env = os.environ.get(name)
    if env is None:
        return default
    val = env.strip().lower()
    if val in ("0", "false", "off", "no"):
        return False
    if val in ("1", "true", "on", "yes"):
        return True
    raise ValueError(
        f"{name}={env!r} is not a recognized switch "
        "(use 0/false/off/no or 1/true/on/yes)"
    )


def resolve_switch(n: int, env_name: str, default: bool = False) -> bool:
    """Config > env > default: ``n`` in (0, 1) forces; -1 defers to
    ``env_switch(env_name, default)``."""
    if n in (0, 1):
        return bool(n)
    return env_switch(env_name, default)


def env_choice(name: str, choices: tuple, default: str) -> str:
    """Parse enum env var ``name``: unset -> ``default``; a (case/space
    insensitive) member of ``choices`` -> that member; anything else raises."""
    env = os.environ.get(name)
    if env is None:
        return default
    val = env.strip().lower()
    if val in choices:
        return val
    raise ValueError(
        f"{name}={env!r} is not a recognized choice (use one of "
        f"{'/'.join(choices)})"
    )


def resolve_choice(s: str, env_name: str, choices: tuple, default: str) -> str:
    """Config > env > default: a non-empty ``s`` forces (must already be
    validated to ``choices``); "" defers to ``env_choice``."""
    if s:
        if s not in choices:
            raise ValueError(
                f"{s!r} is not a recognized choice (use one of "
                f"{'/'.join(choices)})"
            )
        return s
    return env_choice(env_name, choices, default)
