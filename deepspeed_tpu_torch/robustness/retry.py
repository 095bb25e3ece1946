"""Bounded retry-with-backoff for host I/O, a copy of
``deepspeed_tpu/robustness/retry.py`` emitting through this package's
``robustness/events.py``.

Transient faults (an EIO under memory pressure, a network file system's
hiccup) are retried with exponential backoff; a recovery is a structured
``fault_recovered`` event, and the *terminal* error names the operation,
file and attempt count. Every small-file write of the checkpoint
chain goes through here (``robustness/integrity.atomic_write``).
"""

import errno as _errno
import logging
import time
from typing import Callable

from deepspeed_tpu_torch.robustness import events

logger = logging.getLogger("deepspeed_tpu_torch")

# errnos worth retrying: transient media/transport errors. ENOSPC is NOT
# retried: a full disk rarely un-fills within the backoff budget, and the
# caller (a checkpoint save) has a better fallback (keep the previous good
# tag).
TRANSIENT_ERRNOS = frozenset({
    _errno.EIO, _errno.EAGAIN, _errno.EINTR, _errno.EBUSY, _errno.ETIMEDOUT,
})


def _is_transient(err: BaseException) -> bool:
    if not isinstance(err, OSError):
        return False
    # an OSError with no errno (raised by hand, or IOError("msg")) counts
    # as transient, as in the JAX package
    return err.errno is None or err.errno in TRANSIENT_ERRNOS


def retry_io(fn: Callable, *, what: str, path: str, attempts: int = 4,
             backoff_s: float = 0.05):
    """Run ``fn()`` with up to ``attempts`` tries.

    Retries only *transient* ``OSError``s (``TRANSIENT_ERRNOS``); anything
    else (ENOSPC, EACCES, a ``ValueError``) propagates at once. A success
    after >= 1 failure emits a ``fault_recovered`` event. The terminal
    error is an ``OSError`` naming ``what``, ``path`` and the attempt
    count, chained from the last underlying failure.
    """
    last = None
    for attempt in range(1, max(1, attempts) + 1):
        try:
            result = fn()
        except OSError as e:
            if not _is_transient(e):
                raise
            last = e
            if attempt >= attempts:
                break
            logger.warning(f"{what}: transient {e!r} on {path} "
                           f"(attempt {attempt}/{attempts}); retrying")
            time.sleep(backoff_s * (2 ** (attempt - 1)))
            continue
        if attempt > 1:
            events.emit("fault_recovered", kind="io", what=what, path=path,
                        attempts=attempt)
        return result
    raise OSError(
        getattr(last, "errno", None) or _errno.EIO,
        f"{what} failed after {attempts} attempts on {path}: {last}"
    ) from last
