"""UNet forward, loss and backward (`FlowDiffusion.loss` past the pseudo ground truth): device ms per step outside the pseudo ground truth and the optimizer."""

from portbench.harness import readers


def read(run):
    return readers.step_rest_ms(run, "pseudo_ground_truth", "optimizer")
