"""Event channels: the port's counterpart of ``ray_tpu/util/pubsub.py``.

Channels live in the driver's registry (``_private/registry.py``): events
in order, at least once, with a bounded tail of 1,000 events a channel kept for
subscribers that join late (older events are gone, as with the
reference's bounded buffers). Built-in channels:

- ``"actors"``: ``ALIVE`` and ``DEAD`` of every ``ProcessActor`` the
  driver spawned and of every ``WorkerGroup`` rank (``kind``: ``"actor"``
  or ``"rank"``). The port restarts no actor in place: a replaced runner
  or Serve replica is a new actor with its own id, so no ``RESTARTING``
  is published;
- ``"nodes"``: the host's node, ``added`` at the start.

User channels work from the driver and from a port process, whose calls go
to its spawner over its link (``_private/driver_link.py``).

    sub = Subscriber("actors")
    events = sub.poll(timeout=5)   # blocks until events or timeout
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import driver_link


def publish(channel: str, event: dict) -> None:
    """Publish an event (a plain dict) to a channel."""
    driver_link.call("publish", channel, dict(event))


class Subscriber:
    """Ordered, at-least-once event consumption from one channel. Each
    ``poll`` returns only events newer than the last batch; a subscriber
    created after events were published sees the channel's retained tail
    (``start_from_beginning``), or only what comes after it."""

    def __init__(self, channel: str, start_from_beginning: bool = True):
        self.channel = channel
        self._seq = 0 if start_from_beginning else self._latest_seq()

    def _latest_seq(self) -> int:
        seq, _ = driver_link.call("poll", self.channel, 1 << 62, 0.0)
        return seq

    def poll(self, timeout: Optional[float] = 5.0) -> list[dict]:
        """Events published since the previous poll; blocks up to
        ``timeout`` seconds when none are pending (``None``: until the next
        event arrives)."""
        while True:
            seq, events = driver_link.call(
                "poll", self.channel, self._seq, 30.0 if timeout is None else timeout)
            self._seq = max(self._seq, seq)
            if events or timeout is not None:
                return events
