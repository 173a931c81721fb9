"""Serving entry `FlowDiffusion.sample_video`: the calls completed in the window, the count behind `call_p50_ms.serve` and `call_p75_ms.serve`."""


def read(run):
    return float(run.units) if run.units else None
