"""Single-client guard for the GPU (port of ``utils/chiplock.py``).

Every entry point that trains or benchmarks on a GPU (``cli train``, the
bench, the ``tools`` microbenchmarks) takes an exclusive, non-blocking
``flock`` on a well-known lock file first and holds it for the life of the
process: a second client on the card would skew every time the first one
takes, and a crash of one can take the other's work with it. ``flock`` is
released by the kernel when the holder exits or dies, so a stale lock is
impossible; only the holder's pid and purpose written in the file can go
stale.

``QED_CHIP_LOCK`` names the file; by default ``qed_gpu.lock`` in the
temporary directory (``/tmp/qed_gpu.lock``). A run on the CPU never locks.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, TextIO

_LOCK: Optional[TextIO] = None  # held for the life of the process


class ChipBusy(RuntimeError):
    """Another live process holds the GPU lock."""


def lock_path() -> str:
    return os.environ.get("QED_CHIP_LOCK") or os.path.join(
        tempfile.gettempdir(), "qed_gpu.lock")


def accelerator_present(device="cuda") -> bool:
    """True when the caller's device is a GPU (``cuda`` or ``cuda:N``)."""
    return str(device).split(":")[0] == "cuda"


def acquire_chip_lock(purpose: str, required: bool = True,
                      device="cuda") -> bool:
    """Take the exclusive GPU lock (nothing to take for a CPU ``device``).

    Returns True when the lock is held (or not needed). When another live
    process holds it: raises :class:`ChipBusy` if ``required``, else warns
    and returns False. Reentrant within a process."""
    global _LOCK
    if _LOCK is not None or not accelerator_present(device):
        return True
    import fcntl

    path = lock_path()
    fh = open(path, "a+")
    try:
        fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        fh.seek(0)
        holder = fh.read().strip() or "unknown process"
        fh.close()
        msg = (f"the GPU is held by {holder} (lock {path}); run one client "
               "at a time or stop the holder")
        if required:
            raise ChipBusy(msg)
        print(f"WARNING: {msg}")
        return False
    fh.seek(0)
    fh.truncate()
    fh.write(f"pid {os.getpid()} ({purpose})\n")
    fh.flush()
    _LOCK = fh  # the open file keeps the flock
    return True


def release_chip_lock() -> None:
    """Release it before the process ends (tests); an exit releases it."""
    global _LOCK
    if _LOCK is not None:
        _LOCK.close()
        _LOCK = None
