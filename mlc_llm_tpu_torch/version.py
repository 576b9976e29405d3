"""Version info (git-describe based), a copy of ``mlc_llm_tpu/version.py``."""

from __future__ import annotations

import os
import subprocess

__version__ = "0.1.0"


def git_describe() -> str:
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):  # no git, or it hung
        pass
    return "unknown"


def full_version() -> str:
    return f"{__version__}+g{git_describe()}"
