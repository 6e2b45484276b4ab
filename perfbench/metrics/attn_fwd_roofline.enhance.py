"""attn_fwd_roofline.enhance: kernel #1 (the program's fused forward of
the relative-position attention) as a % of its roofline.

The bound of a launch is the least time an H100 could take for it
(perfbench.work.roofline_seconds of perfbench.work.attention_work at its
shapes). A call's launches (the program's counter over the window, over
the calls) serve its longest attention sequences, the reference's
attention calls taken longest first. The share is the window's summed
bounds over the summed device time of the kernels named below."""

import re

from perfbench import work
from perfbench.readings import unit_work

KERNELS = re.compile(r"flash_rel_(fwd|wide_fwd|wide_split)")


def read(reading):
    m, tr = reading.measured, reading.trace
    launches = reading.counters.get("attn_fwd", 0)
    if tr is None or not m["units"] or not launches or launches % m["units"]:
        return None
    seconds = tr.op_seconds(lambda name: bool(KERNELS.search(name)))
    if seconds <= 0:
        return None
    count = unit_work(reading)
    elem = {"float32": 4, "bfloat16": 2}[reading.cell.cfg["dtype"]]
    calls = sorted(count.attention, key=lambda a: -a[1])[:launches // m["units"]]
    bound = sum(work.roofline_seconds(work.attention_work(g, t, t, t, 0, count.max_pos, d, elem))
                for g, t, d, _ in calls)
    return 100.0 * m["units"] * bound / seconds
