"""Percent of the roofline of the solve layer: the least time its calls
need (``roofline.work``) over the device time of the kernels they
launched (traced runs only)."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("solve", run.spans.get("solve", []),
                              run.trace.layer_device_s().get("solve", 0.0))
