"""The non-finite loss policy (counterpart of the ``TRAIN.NONFINITE`` half
of distribuuuu_tpu/resilience/supervisor.py).

* ``raise``: fail at the next metric flush (``PRINT_FREQ``) with
  :class:`NonFiniteLossError`; steps dispatch without a host sync between
  flushes.
* ``skip``: the poisoned update is discarded and the state before the step
  is kept (parameters, optimizer state and BN running stats; the step
  cursor still advances). The trainer reads the loss's finiteness after
  every forward for this, one host sync per step.
* ``rollback`` (reload the last checkpoint) is not ported.
"""

from __future__ import annotations

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.utils.logger import get_logger

NONFINITE_POLICIES = ("raise", "skip", "rollback")


class NonFiniteLossError(RuntimeError):
    """The loss went NaN/Inf under the ``raise`` policy."""

    def __init__(self, epoch: int, batch: int, value: float):
        super().__init__(
            f"non-finite loss ({value}) at epoch {epoch + 1}, batch ~{batch}. "
            "Policy TRAIN.NONFINITE: 'raise' (this) or 'skip' (discard the step)"
        )
        self.epoch = epoch
        self.batch = batch
        self.value = value


def validate_policy(policy: str) -> str:
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"TRAIN.NONFINITE={policy!r}: must be one of {NONFINITE_POLICIES}")
    if policy == "rollback":
        raise not_ported("TRAIN.NONFINITE rollback", "Real data and many processes")
    return policy


class NonFiniteMonitor:
    """Host half of the policy: reads the fetched ``nonfinite`` flags at
    flush time; counts and logs under ``skip``, raises under ``raise``."""

    def __init__(self, policy: str, epoch: int, logger=None):
        self.policy = validate_policy(policy)
        self.epoch = epoch
        self.logger = logger or get_logger()
        self.skipped = 0

    def observe(self, loss: float, nonfinite: float, batch: int) -> bool:
        """True when this step was skipped (keep it out of the meters)."""
        if not nonfinite:
            return False
        if self.policy == "skip":
            self.skipped += 1
            self.logger.warning(
                "non-finite loss at epoch %d batch ~%d — update skipped "
                "(TRAIN.NONFINITE=skip; %d skipped so far)",
                self.epoch + 1, batch, self.skipped,
            )
            return True
        raise NonFiniteLossError(self.epoch, batch, loss)
