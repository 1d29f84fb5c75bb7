"""The one place that names the port's default device.

Entry points that create tensors (``utils.data``, ``convert``, ``io``) take
``device=None`` and place them on :func:`default_device`: the card.  There is
no test for a card and no giving way to the CPU: without one, torch's own
error is the answer.  Callers that want the CPU (the tests) say
``device="cpu"``.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
