"""Graceful preemption: SIGTERM -> checkpoint-and-exit, the port's copy of
``deepspeed_tpu/robustness/preemption.py``.

A ``PreemptionHandler`` latches the signal into a flag (handlers must not
checkpoint from signal context: neither the serialization nor the card's
runtime is reentrant), and the loop polling ``requested`` saves at its
next boundary and raises ``Preempted``. The serving engine's
``attach_preemption`` is one such loop: a latched SIGTERM drains the
engine at the next ``step()`` and a restarted engine ``resume``s the
drain. The launcher's grace window between SIGTERM and SIGKILL is the
budget for that save.
"""

import logging
import signal
from typing import Dict, Optional, Sequence

from deepspeed_tpu_torch.robustness import events

logger = logging.getLogger("deepspeed_tpu_torch")


class Preempted(RuntimeError):
    """Raised by the loop after the preemption checkpoint (or serving
    drain) is durable — the caller should exit cleanly (rc 0: the work is
    saved)."""

    def __init__(self, message: str, step: int = -1, ckpt_path: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.ckpt_path = ckpt_path


class PreemptionHandler:
    """Latches SIGTERM (and any extra signals) into a poll-able flag.

    Usage::

        handler = PreemptionHandler().install()
        srv.attach_preemption(handler, drain_dir)
        try:
            while ...:
                srv.step()
        except Preempted:
            sys.exit(0)   # drained; a restarted engine resumes it

    ``install``/``restore`` save and put back the previous handlers, so a
    parent's own forwarding is never disturbed — each process owns its
    handlers.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.received: Optional[int] = None
        self._requested = False
        self._prev: Dict[int, object] = {}
        self._installed = False

    def _on_signal(self, signum, _frame):
        # signal context: latch the flag only — no I/O, no device work
        self._requested = True
        self.received = signum

    def install(self) -> "PreemptionHandler":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._requested

    def reset(self) -> None:
        """Clear the latch (after the preemption was handled; a resumed
        in-process loop reuses the handler)."""
        self._requested = False
        self.received = None

    def acknowledge(self, step: int, ckpt_path: Optional[str] = None) -> None:
        """Record that the checkpoint-and-exit contract was honored."""
        logger.warning(f"preemption: checkpointed at step {step}; exiting")
        events.emit("preempted", step=step, signal=self.received,
                    ckpt_path=ckpt_path)

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()
