"""Serve response streaming: the port's own copy of
``ray_tpu/serve/streaming.py``.

A replica's ``handle_request_streaming`` is a generator method run with
``ProcessActor.call_stream``: each chunk it yields goes over the replica's
reply pipe as it is produced, and the proxy writes chunks to the socket as
they arrive (chunked transfer-encoding / SSE). The JAX package seals each
chunk into its object store and moves large bodies zero-copy
(``streaming.py:104``); the port has no object store, so every chunk, and
every body, travels by value over the pipes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class StreamStart:
    """First item of a streamed deployment response: tells the proxy to
    switch to chunked/SSE output with this content type instead of buffering
    a single JSON body. User handlers may yield one explicitly as the first
    item to control the content type; otherwise the replica infers one.
    ``status``/``headers`` carry the full response head (the proxy writes
    them verbatim; content-type/length excluded from ``headers``)."""

    content_type: str = "text/event-stream"
    status: int = 200
    headers: Optional[list] = None  # [(name, value)] strings


class RawBody:
    """A raw response body. In the JAX package replicas wrap large bytes in
    it to ride the object store's zero-copy path; in the port it is a
    plain wrapper that pickles its bytes by value, which a handler may
    return to have the proxy send the bytes as they are."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data  # bytes / memoryview / any buffer

    def __len__(self) -> int:
        # bytes, not elements: a typed view is sized by nbytes
        return memoryview(self.data).nbytes

    def view(self) -> memoryview:
        return memoryview(self.data).cast("B")

    def tobytes(self) -> bytes:
        return self.data if isinstance(self.data, bytes) else bytes(self.view())

    def __reduce__(self):
        return (RawBody, (self.tobytes(),))


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call's chunk values
    (reference: ``DeploymentResponseGenerator``,
    ``python/ray/serve/handle.py``). ``source`` is the call's
    ``StreamResult`` (or, in a replica, the relayed stream of
    ``handle.py:_RouterClient``); collecting this generator before its end
    collects the source, which cancels the producer."""

    def __init__(self, source):
        self._source = source
        # the replica's protocol-level StreamStart is absorbed here rather
        # than yielded: handle-level consumers see only user chunks; the
        # proxy reads .stream_start to pick content type
        self.stream_start: Optional[StreamStart] = None
        # RawBody is proxy protocol: handle-level consumers get the bytes
        # back; the proxy turns this off to see the wrapper
        self.unwrap_raw = True

    def __iter__(self) -> "DeploymentResponseGenerator":
        return self

    def __next__(self) -> Any:
        return self.next(timeout_s=None)

    def next(self, timeout_s: Optional[float] = None) -> Any:
        while True:
            value = self._source.next(timeout=timeout_s)
            if isinstance(value, StreamStart):
                self.stream_start = value
                continue
            if self.unwrap_raw and isinstance(value, RawBody):
                return value.tobytes()
            return value

    def cancel(self) -> None:
        """Stop the producer; chunks not yet taken are dropped."""
        self._source.cancel()
