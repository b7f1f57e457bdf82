"""Kernels: the screen's share of its roofline, in %.  The least time the
screen's work needs (``work_count.screen_work`` for every batch traced,
from the configuration's sizes and the traffic's batch) over the summed
device time of the screening kernels (names holding ``dco_scan``) in the
traced window."""
from perfbench import work_count


def read(run):
    t, w = run.trace, run.traced_work
    if t is None or not w.get("batches"):
        return None
    kernel_s = t.device_seconds("dco_scan")
    if kernel_s <= 0:
        return None
    cfg = run.config
    nbytes, flops = work_count.screen_work(
        int(cfg["n"]), int(cfg["dim"]), int(cfg["policy"].get("d1", 128)),
        int(w["batch"]))
    return 100.0 * w["batches"] * work_count.least_seconds(nbytes, flops) / kernel_s
