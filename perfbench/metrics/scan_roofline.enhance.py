"""scan_roofline.enhance: the program's selective-scan kernel as a % of its
roofline.

The bound of a call is the sum over its scans (perfbench.archs.semamba.
scan_calls: each TF-Mamba block's two directions along time and along
frequency) of the larger of the scan's bytes at 3.35 TB/s and its flop at
the H100's 67 TFLOP/s of float32 outside the tensor cores (scan_work, at
mamba_ssm's selective_scan_fn operand boundary), the same however the
program groups or fuses the scans. The share is the window's calls'
bounds over the device time, inside the window, of the kernels the program
names as its scan kernels. None unless the program counted scan launches,
a whole number a call."""

from perfbench import archs


def read(reading):
    m, tr, cfg = reading.measured, reading.trace, reading.cell.cfg
    launches = reading.counters.get("scan", 0)
    if tr is None or not m["units"] or not launches or launches % m["units"]:
        return None
    arch = archs.load(cfg)
    names = arch.scan_kernels()
    seconds = tr.op_seconds(lambda name: any(k in name for k in names))
    if seconds <= 0:
        return None
    u = m["unit"]
    return 100.0 * m["units"] * arch.scan_bound_seconds(cfg, u["batch"], u["samples"]) / seconds
