"""Natural-order sorting (the reference depends on the `natsort` wheel,
src/data/dataloader.py:19, src/evaluation.py:71). 'p232_10.wav' sorts
after 'p232_2.wav'."""

from __future__ import annotations

import re
from typing import Iterable, List

_NUM_RE = re.compile(r"(\d+)")


def natsort_key(s: str):
    return tuple(
        int(part) if part.isdigit() else part.lower()
        for part in _NUM_RE.split(s)
    )


def natsorted(items: Iterable[str]) -> List[str]:
    return sorted(items, key=natsort_key)
