"""Validated environment-variable knobs.

Every ``ASR_*`` choice knob parses through :func:`choice_env` so a typo
fails loudly at import with the variable name and the valid values —
instead of a bare ``KeyError`` (the dict-lookup sites) or, worse, being
silently read as some other mode (for a precision knob that would
silently pick a parity-affecting reduced-precision path).
"""

from __future__ import annotations

import os
from typing import Sequence


def choice_env(name: str, default: str, choices: Sequence[str]) -> str:
    """Read env var ``name`` (default ``default``) and require it to be
    one of ``choices``; raise ``ValueError`` naming the knob otherwise."""
    val = os.environ.get(name, default)
    if val not in choices:
        raise ValueError(
            f"{name}={val!r} is not a valid value; "
            f"choose one of: {', '.join(choices)}"
        )
    return val
