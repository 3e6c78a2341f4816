"""Build/version stamping.

The reference embeds a git-describe VERSION_STRING in every binary and
the library (pgr-tk/build.rs:27-38, `--version` on each CLI via clap);
equivalent here: package version plus the git description of the source
tree when one is available, cached per process.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

_cached: Optional[str] = None


def version_string() -> str:
    global _cached
    if _cached is None:
        from .. import __version__

        desc = ""
        try:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            )))
            out = subprocess.run(
                ["git", "describe", "--always", "--dirty"],
                cwd=root, capture_output=True, timeout=5,
            )
            if out.returncode == 0:
                desc = out.stdout.decode().strip()
        except Exception:
            pass
        _cached = f"pgrtk {__version__}" + (f" ({desc})" if desc else "")
    return _cached


def add_version_arg(parser) -> None:
    """Attach --version to an argparse parser, deferring the git
    subprocess in version_string() to when the flag actually fires."""
    import argparse

    class _Version(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            parser.exit(message=version_string() + "\n")

    parser.add_argument(
        "--version", action=_Version, nargs=0,
        help="show version and exit",
    )
