"""Webhook notifications (Slack's JSON body).

Copy of ``magellanmapper_tpu/cloud/notify.py``: :func:`notify` posts a
message and reports success, :func:`post` posts a message with the last
20 lines of an attachment file and returns the response.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Optional

from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)


def notify(
        webhook_url: str, msg: str, attachment: Optional[str] = None,
        timeout: float = 10.0) -> bool:
    """POST ``{"text": msg}`` (with ``attachment`` as an attachment's
    text) to a Slack-compatible webhook; False on any failure."""
    payload = {"text": msg}
    if attachment:
        payload["attachments"] = [{"text": attachment}]
    req = urllib.request.Request(
        webhook_url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ok = resp.status == 200
    except Exception as exc:
        _logger.warning("notification failed: %s", exc)
        return False
    return ok


def post(url: str, msg: str, attachment: Optional[str] = None):
    """POST a Slack-style JSON message with the last 20 lines of the
    ``attachment`` file; returns the ``urlopen`` response (raises on
    failure)."""
    fields = {"text": msg}
    if attachment:
        lines = libmag.last_lines(attachment, 20)
        if lines:
            fields["attachments"] = [{"text": "\n".join(lines)}]
    req = urllib.request.Request(
        url, json.dumps(fields).encode("utf8"),
        {"Content-type": "application/json"})
    return urllib.request.urlopen(req)
