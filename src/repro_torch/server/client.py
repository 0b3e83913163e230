"""Minimal asyncio streaming client for the ``repro_torch.server`` frontend.

Stdlib-only HTTP/1.1 with chunked-transfer decoding, shared by the
end-to-end tests and the overload example so neither hand-rolls the wire
format.  ``stream_generate`` consumes the NDJSON token stream as it arrives
and returns the full transcript; ``get_json`` fetches a JSON endpoint
(``/healthz``).

Counterpart of ``repro.server.client``: stdlib only, nothing of torch.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
from typing import (Any, Awaitable, Callable, Dict, List, Optional, Sequence,
                    Tuple)

#: Transport failures worth retrying (the server went away mid-exchange or
#: never answered) — as opposed to protocol errors, which never heal.
RETRYABLE_ERRORS = (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, OSError)


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with seeded jitter for ``stream_generate``.

    Attempt ``k`` (0-based) sleeps ``backoff_s * multiplier**k``, scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]`` drawn from a private
    ``random.Random(seed)`` — deterministic per policy instance, and spread
    out across instances seeded differently so a shed thundering herd
    doesn't re-arrive in lockstep.  A 503's ``Retry-After`` header, when
    longer, takes precedence over the computed backoff."""

    max_retries: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.1              # fraction of the delay, uniform +/-
    seed: int = 0
    retry_statuses: Tuple[int, ...] = (503,)

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        self._rng = random.Random(self.seed)

    def delay_s(self, attempt: int,
                retry_after_s: Optional[float] = None) -> float:
        base = self.backoff_s * self.multiplier ** attempt
        base *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        if retry_after_s is not None:
            base = max(base, retry_after_s)
        return base


@dataclasses.dataclass
class GenerateResult:
    """Outcome of one streamed /v1/generate call."""
    http_status: int
    tokens: List[int]
    summary: Dict[str, Any]          # final NDJSON line (or the error body)
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    attempts: int = 1                # 1 = first try succeeded / no retry

    @property
    def status(self) -> str:
        return str(self.summary.get("status", "error"))

    @property
    def ok(self) -> bool:
        return self.http_status == 200


async def _read_headers(reader: asyncio.StreamReader):
    status_line = (await reader.readline()).decode("latin-1").strip()
    parts = status_line.split()
    if len(parts) < 2 or not parts[1].isdigit():
        # the server died (or reset) before answering: surface it as the
        # retryable incomplete-read it is, not a parse crash
        raise asyncio.IncompleteReadError(status_line.encode("latin-1"), None)
    http_status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        key, _, val = raw.decode("latin-1").partition(":")
        headers[key.strip().lower()] = val.strip()
    return http_status, headers


async def _read_body(reader: asyncio.StreamReader,
                     headers: Dict[str, str]) -> bytes:
    if headers.get("transfer-encoding", "").lower() == "chunked":
        out = b""
        while True:
            size = int((await reader.readline()).strip() or b"0", 16)
            if size == 0:
                await reader.readline()       # trailing CRLF
                return out
            out += await reader.readexactly(size)
            await reader.readexactly(2)       # chunk CRLF
    n = int(headers.get("content-length", "0") or 0)
    return await reader.readexactly(n) if n else b""


async def _request(host: str, port: int, method: str, path: str,
                   body: Optional[bytes] = None):
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = body or b""
        head = (f"{method} {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n")
        writer.write(head.encode() + body)
        await writer.drain()
        http_status, headers = await _read_headers(reader)
        payload = await _read_body(reader, headers)
        return http_status, headers, payload
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def get_json(host: str, port: int, path: str) -> Dict[str, Any]:
    status, _, payload = await _request(host, port, "GET", path)
    out = json.loads(payload or b"{}")
    out["_http_status"] = status
    return out


def _parse_retry_after(headers: Dict[str, str]) -> Optional[float]:
    raw = headers.get("retry-after")
    try:
        return None if raw is None else float(raw)
    except ValueError:
        return None


async def stream_generate(host: str, port: int, prompt: Sequence[int],
                          max_new_tokens: int = 8,
                          priority: str = "normal",
                          deadline_s: Optional[float] = None,
                          timeout_s: float = 120.0,
                          retry: Optional[RetryPolicy] = None,
                          sleep: Callable[[float], Awaitable[None]]
                          = asyncio.sleep) -> GenerateResult:
    """One /v1/generate stream, optionally retried under ``retry``.

    Retries fire on retryable transport errors and on the policy's
    ``retry_statuses`` (503 overload by default), honouring the server's
    ``Retry-After``.  ``sleep`` is injectable so tests assert the backoff
    schedule without waiting it out.  With ``retry=None`` a transport error
    propagates, as before."""
    body = json.dumps({
        "prompt": list(prompt), "max_new_tokens": max_new_tokens,
        "priority": priority, "deadline_s": deadline_s,
    }).encode()
    max_attempts = 1 + (retry.max_retries if retry is not None else 0)
    attempt = 0
    while True:
        try:
            status, headers, payload = await asyncio.wait_for(
                _request(host, port, "POST", "/v1/generate", body), timeout_s)
        except RETRYABLE_ERRORS:
            if retry is None or attempt + 1 >= max_attempts:
                raise
            await sleep(retry.delay_s(attempt))
            attempt += 1
            continue
        if retry is not None and status in retry.retry_statuses \
                and attempt + 1 < max_attempts:
            await sleep(retry.delay_s(attempt, _parse_retry_after(headers)))
            attempt += 1
            continue
        break
    tokens: List[int] = []
    summary: Dict[str, Any] = {}
    for line in payload.decode().splitlines():
        if not line.strip():
            continue
        obj = json.loads(line)
        if "token" in obj:
            tokens.append(int(obj["token"]))
        else:
            summary = obj
    return GenerateResult(http_status=status, tokens=tokens, summary=summary,
                          headers=dict(headers), attempts=attempt + 1)
