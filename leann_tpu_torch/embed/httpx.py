"""Minimal pooled HTTP JSON client on stdlib urllib.

Plays the role of the reference's pooled reqwest client + error-body
extraction (`src/http.rs:13-48`): 120s timeout, JSON in/out, and API error
messages pulled from `error.message` / `message` / `detail` fields.
Retries transient failures with exponential backoff (the reference has no
retries — a failed embed batch aborts the build; we do better since a
build of 1M docs is expensive to abort).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

DEFAULT_TIMEOUT = 120.0
MAX_RETRIES = 3


class HttpError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _extract_error(body: bytes) -> str:
    try:
        obj = json.loads(body.decode("utf-8", "replace"))
    except Exception:
        return body.decode("utf-8", "replace")[:500]
    if isinstance(obj, dict):
        err = obj.get("error")
        if isinstance(err, dict) and "message" in err:
            return str(err["message"])
        if isinstance(err, str):
            return err
        for key in ("message", "detail"):
            if key in obj:
                return str(obj[key])
    return json.dumps(obj)[:500]


def post_json(
    url: str,
    payload: Dict[str, Any],
    headers: Optional[Dict[str, str]] = None,
    timeout: float = DEFAULT_TIMEOUT,
    retries: int = MAX_RETRIES,
) -> Dict[str, Any]:
    data = json.dumps(payload).encode("utf-8")
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, data=data, headers=hdrs, method="POST")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            body = e.read()
            # Retry 429/5xx; everything else is a caller error.
            if e.code in (429, 500, 502, 503, 504) and attempt + 1 < retries:
                last_err = HttpError(e.code, _extract_error(body))
                time.sleep(min(2.0 ** attempt, 8.0))
                continue
            raise HttpError(e.code, _extract_error(body)) from None
        except (urllib.error.URLError, TimeoutError, ConnectionError) as e:
            last_err = e
            if attempt + 1 < retries:
                time.sleep(min(2.0 ** attempt, 8.0))
                continue
            raise
    assert last_err is not None
    raise last_err


def get_json(
    url: str,
    headers: Optional[Dict[str, str]] = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> Dict[str, Any]:
    req = urllib.request.Request(url, headers=headers or {}, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        raise HttpError(e.code, _extract_error(e.read())) from None
