"""Percent of the roofline of the frequencies layer: the least time its calls
need (``roofline.work``) over the device time of the kernels they
launched (traced runs only)."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("frequencies", run.spans.get("frequencies", []),
                              run.trace.layer_device_s().get("frequencies", 0.0))
