"""Per-tenant crash isolation for the ingestion daemon (DESIGN.md §15).

A tenant whose store keeps failing must not take the daemon down — or
even slow the other tenants. ``TenantSupervisor`` wraps store opening
in ``parallel.RetryPolicy`` (same jittered backoff as the worker pools,
same injectable clock/rng so fault tests assert exact schedules) and
tracks a ``CircuitBreaker`` per tenant: after ``threshold`` consecutive
failures the tenant is rejected at admission with a structured
``circuit_open`` error until ``cooldown`` has elapsed — a half-open
probe then either closes the circuit or re-arms it.
"""

from __future__ import annotations

import threading
import time

from ..core.parallel import RetryPolicy
from .protocol import ProtocolError

# deterministic errors: the input/config is wrong, retrying cannot help
_FATAL = (ValueError, TypeError, KeyError)


class CircuitBreaker:
    """Consecutive-failure breaker with injectable clock.

    closed -> (threshold failures) -> open -> (cooldown) -> half-open:
    one probe is allowed through; its success closes the circuit, its
    failure re-opens it for another cooldown."""

    def __init__(self, threshold: int = 3, cooldown: float = 30.0,
                 clock=time.monotonic):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.clock = clock
        self.failures = 0
        self.opened_at: float | None = None
        self._probe_out = False
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May a request proceed right now? (A half-open probe is
        consumed by this call — report its outcome.)"""
        with self._lock:
            if self.opened_at is None:
                return True
            if self.clock() - self.opened_at < self.cooldown:
                return False
            if self._probe_out:
                return False  # one probe at a time
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.opened_at = None
            self._probe_out = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._probe_out = False
            if self.failures >= self.threshold or self.opened_at is not None:
                self.opened_at = self.clock()

    @property
    def open(self) -> bool:
        with self._lock:
            return self.opened_at is not None and \
                self.clock() - self.opened_at < self.cooldown


class TenantSupervisor:
    """Retry + circuit-breaker policy around per-tenant store lifecycle."""

    def __init__(self, policy: RetryPolicy | None = None, *,
                 breaker_threshold: int = 3, breaker_cooldown: float = 30.0,
                 clock=time.monotonic):
        self.policy = policy or RetryPolicy(attempts=2, base_delay=0.05)
        self.clock = clock
        self._threshold = breaker_threshold
        self._cooldown = breaker_cooldown
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def breaker(self, tenant: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(tenant)
            if br is None:
                br = self._breakers[tenant] = CircuitBreaker(
                    self._threshold, self._cooldown, self.clock)
            return br

    def open_store(self, tenant: str, factory):
        """Open a tenant store through the breaker + retry policy.

        Transient failures (``OSError``: ENOSPC, EIO, a mount blinking)
        are retried ``policy.attempts`` times with jittered backoff;
        deterministic ones (corrupt beyond repair -> ``ValueError``)
        fail immediately. Either way the final failure trips the
        breaker; success resets it."""
        br = self.breaker(tenant)
        if not br.allow():
            raise ProtocolError(
                "circuit_open",
                f"tenant {tenant}: circuit open after {br.failures} "
                f"consecutive failures — retry after cooldown")
        last: Exception | None = None
        for attempt in range(self.policy.attempts):
            try:
                store = factory()
            except _FATAL as e:
                br.record_failure()
                raise ProtocolError("open_failed",
                                    f"tenant {tenant}: {e}") from e
            except OSError as e:
                last = e
                if attempt + 1 < self.policy.attempts:
                    self.policy.backoff(attempt)
                continue
            br.record_success()
            return store
        br.record_failure()
        raise ProtocolError("open_failed",
                            f"tenant {tenant}: {last}") from last

    def record_failure(self, tenant: str, exc: Exception | None = None) -> None:
        """Runtime (post-open) tenant failure — feeds the same breaker,
        so a tenant crash-looping at ingest time eventually stops being
        readmitted every reconnect."""
        self.breaker(tenant).record_failure()

    def status(self) -> dict:
        with self._lock:
            return {t: {"failures": b.failures, "open": b.open}
                    for t, b in self._breakers.items()}
