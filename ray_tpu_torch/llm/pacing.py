"""Per-token emission smoothing between the decode buffer and SSE writers.

The port's own copy of ``ray_tpu/llm/pacing.py`` (the port imports nothing
from ``ray_tpu``).

Multi-step decode (``EngineConfig.decode_steps`` > 1) and run-ahead deliver
sampled tokens to the host in K-sized blocks: without smoothing an SSE
client sees one burst per dispatched program and the intertoken p50
collapses to ~0 (the intra-burst gap) while the p99 is the whole program
interval. The pacer spreads each block over the *observed* inter-block
interval, so the client-visible token cadence approximates the true
sustained rate with no throughput cost: the next block keeps arriving while
the previous one is being metered out.

Producers call ``note_block(n)`` when an n-token block is applied; the
stream drain calls ``gate(backlog=...)`` before each emission.
"""

from __future__ import annotations

import time

# never stretch a token beyond this, even if blocks arrive slowly — a stall
# (GC pause, rebuild) must not smear into seconds of artificial latency
_MAX_PACE_S = 0.1
# minimum spacing applied inside a burst: keeps measured intertoken gaps
# strictly positive (and honest) without being perceptible
_MIN_PACE_S = 1e-3


class TokenPacer:
    """Per-request pacing state. Thread-compatible by construction: the
    producer (scheduler/engine thread) only writes ``pace_s`` and
    ``_last_block_t`` (float stores are atomic in CPython) and the consumer
    (stream drain) only reads ``pace_s``."""

    __slots__ = ("pace_s", "_last_block_t")

    def __init__(self):
        self.pace_s = 0.0
        self._last_block_t: float | None = None

    def note_block(self, n: int) -> None:
        """An n-token block just landed. Estimate per-token spacing as the
        inter-block interval divided by the block size."""
        now = time.monotonic()
        last, self._last_block_t = self._last_block_t, now
        if n <= 1:
            # single-step decode: tokens already arrive one at a time with
            # real gaps — pacing would only add latency
            self.pace_s = 0.0
        elif last is not None:
            self.pace_s = min(max((now - last) / n, _MIN_PACE_S), _MAX_PACE_S)
        else:
            # first block of the stream: no interval observed yet — use the
            # floor so the burst is at least minimally spaced
            self.pace_s = _MIN_PACE_S

    def gate(self, backlog: bool) -> None:
        """Called by the drain before emitting a token. Sleeps the pacing
        interval only while a backlog exists (tokens queued behind this
        one): a token that arrived alone is already late — never delay it."""
        if backlog and self.pace_s > 0.0:
            time.sleep(self.pace_s)
