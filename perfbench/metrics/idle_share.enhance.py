"""idle_share.enhance: % of the traced window with no operation on the
card, from the union of the device operations' intervals
(perfbench.readings.idle_share)."""

from perfbench.readings import idle_share as read  # noqa: F401
