"""Shared HTTP plumbing for the remote providers, over the port's own HTTP
client: its :class:`~calfkit_tpu_torch._http.HTTPError` (a refused or reset
connection, a timeout, a body cut short) becomes :class:`ModelAPIError` here,
as the JAX package's ``httpx.HTTPError`` does."""

from __future__ import annotations

from typing import Any

import json

from calfkit_tpu_torch._http import HTTPError
from calfkit_tpu_torch.exceptions import CalfkitError


def content_str(content: Any) -> str:
    """Coerce arbitrary tool-return / user content to transportable text."""
    from calfkit_tpu_torch.models.payload import render_parts_as_text

    if isinstance(content, str):
        return content
    if isinstance(content, list):
        try:
            return render_parts_as_text(content)
        except Exception:  # noqa: BLE001
            return str(content)
    try:
        return json.dumps(content)
    except (TypeError, ValueError):
        return str(content)


class ModelAPIError(CalfkitError):
    """A remote model API failure (non-2xx or malformed payload).

    ``error_code`` / ``error_message`` carry the provider's STRUCTURED error
    fields (OpenAI ``error.code``/``error.type``, Anthropic
    ``error.type``/``error.message``) when the body parsed — classification
    downstream (engine/turn.py) prefers these over substring-matching the
    raw body, which can echo user text."""

    def __init__(self, message: str, *, status: int | None = None,
                 body: str | None = None):
        self.status = status
        # parse the UNTRUNCATED body (truncation would cut the JSON and
        # silently demote classification to the substring fallback), then
        # truncate for storage
        self.error_code, self.error_message = _parse_error_fields(body or "")
        self.body = (body or "")[:2000]
        super().__init__(
            f"{message}" + (f" (HTTP {status})" if status else "")
            + (f": {self.body[:400]}" if self.body else "")
        )


def _parse_error_fields(body: str) -> tuple[str | None, str | None]:
    """Extract (code-or-type, provider message) from a JSON error body."""
    if not body:
        return None, None
    try:
        data = json.loads(body)
    except ValueError:
        return None, None
    err = data.get("error") if isinstance(data, dict) else None
    if not isinstance(err, dict):
        return None, None
    # first STRING among code/type — some backends put an int HTTP status in
    # 'code', which must not shadow a usable string 'type'
    code = next(
        (v for v in (err.get("code"), err.get("type")) if isinstance(v, str)),
        None,
    )
    msg = err.get("message")
    return code, msg if isinstance(msg, str) else None


async def post_json(
    client: Any, url: str, *, headers: dict[str, str], payload: dict,
    provider: str,
) -> dict:
    """POST and decode, normalizing every failure into ModelAPIError."""
    try:
        response = await client.post(url, headers=headers, json=payload)
    except HTTPError as exc:
        raise ModelAPIError(f"{provider} request failed: {exc}") from exc
    if response.status_code // 100 != 2:
        raise ModelAPIError(
            f"{provider} API error", status=response.status_code,
            body=response.text,
        )
    try:
        return response.json()
    except ValueError as exc:
        raise ModelAPIError(
            f"{provider} returned non-JSON", status=response.status_code,
            body=response.text,
        ) from exc


async def sse_lines(client: Any, url: str, *, headers: dict[str, str],
                    payload: dict, provider: str):
    """POST with ``stream=True`` and yield SSE ``data:`` payload strings.

    Normalizes transport failures and non-2xx into ModelAPIError before the
    first yield, so callers can trust the stream once it starts."""
    try:
        async with client.stream(
            "POST", url, headers=headers, json=payload
        ) as response:
            if response.status_code // 100 != 2:
                body = (await response.aread()).decode("utf-8", "replace")
                raise ModelAPIError(
                    f"{provider} API error", status=response.status_code,
                    body=body,
                )
            async for line in response.aiter_lines():
                line = line.strip()
                if line.startswith("data:"):
                    yield line[5:].strip()
    except HTTPError as exc:
        raise ModelAPIError(f"{provider} stream failed: {exc}") from exc
