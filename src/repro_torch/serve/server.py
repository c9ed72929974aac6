"""The request record of the serving stack (``repro/serve/server.py``'s
``Request``).  The dense reference ``Server`` is not ported: the paged
engine is held to the JAX engine directly."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["Request"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    out: Optional[List[int]] = None
