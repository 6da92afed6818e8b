"""The mean ``repro_torch.serve.prep`` span of the traced stretch: a bucket
from its start to its first dispatch (each request's copies to the device
and padding, the stacks of states and pending, the cap tensors)."""
from vpbench import hostspans


def read(rec):
    return hostspans.mean_ms(rec, hostspans.PREP)
