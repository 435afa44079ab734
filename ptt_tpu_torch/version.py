"""``ptt_tpu_torch.__version__``: the base version, suffixed with the git SHA of
the checkout when git can read it (the JAX package's ``version.py``, the
reference's setup.py:8-14). Computed on first use, not on import: importing the
package starts no process."""

import functools
import subprocess
from pathlib import Path

BASE_VERSION = "0.1.0"


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


@functools.cache
def version() -> str:
    sha = _git_sha()
    return f"{BASE_VERSION}+{sha}" if sha else BASE_VERSION
