"""Version info (reference: ``src/pathway_explanations/version.py``)."""

from __future__ import annotations

import os
import subprocess

VERSION = "0.1.0"


def get_git_hash() -> str:
    """Current git hash, or 'UNHASHED' outside a repo (reference
    ``version.py:20-33``)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=5,
        )
        h = out.stdout.strip()
        return h if h else "UNHASHED"
    except Exception:
        return "UNHASHED"


def get_version(with_git_hash: bool = False) -> str:
    """Version string, optionally with the git hash (reference version.py:35)."""
    return f"{VERSION}-{get_git_hash()}" if with_git_hash else VERSION
