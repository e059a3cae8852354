"""Build-at-first-use loader for the C++ libraries in csrc/.

The libraries are not committed: the first process that needs one runs
`make -C csrc <lib>` under an exclusive file lock (parallel test workers
would otherwise race on the same output file), then loads it with ctypes.
make rebuilds only when a source is newer than the library. A failed build
raises with the compiler's output; nothing falls back silently.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")

_LOADED: dict[str, ctypes.CDLL] = {}


def build(name: str) -> str:
    """Build csrc/<name> if missing or stale and return its path."""
    path = os.path.join(CSRC, name)
    with open(os.path.join(CSRC, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            proc = subprocess.run(["make", "-C", CSRC, name],
                                  capture_output=True, text=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if proc.returncode != 0 or not os.path.exists(path):
        raise RuntimeError(
            f"building csrc/{name} failed (make exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(build(name))
    return lib
